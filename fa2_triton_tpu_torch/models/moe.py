"""Mixtral-style mixture-of-experts decoder on the port's attention kernels
(port of `fa2_triton_tpu/models/moe.py`).

An MoE model is a `LlamaModel` built from an `MoEConfig`: each layer holds
an fp32 `router` [dim, E] and experts stacked on a leading E axis
(`we_gate` / `we_up` [E, dim, hidden], `we_down` [E, hidden, dim]) in place
of the dense MLP, under the JAX names and orientation, so conversion is a
copy and every LLaMA path and the Engine take it unchanged
(`models/llama.py:_mlp_block` sends a router layer to `moe_mlp_dense`).
Attention is LLaMA's, so training takes the same kernels.

Training (`forward`, `loss_fn`) runs `moe_mlp`: top-k routing with the
top-k weights renormalized, a fixed capacity per expert, choice-priority
slots (every first choice claims its slot before any second choice), and
tokens past capacity dropped (their MLP output is 0, the residual passes).
JAX builds one-hot [T, E, C] dispatch and combine tensors and contracts
them by einsum; here the same slots are index tensors: each (token, choice)
is copied into row `expert * C + slot` of the experts' buffers, and the
combine gathers its rows back, so no [T, E, C] tensor or its matmuls exist.
The experts' SwiGLU runs as batched matmuls over their [C, dim] buffers.

Expert parallelism: `moe_param_pspecs` (JAX l.273-295) cuts the stacked
experts on E over the `model` axis and the attention on heads, the router
replicated; `make_ep_mlp(mesh)` (JAX l.176-211) is the `mlp_fn` of such a
shard: routing and the slots are computed replicated (the same slots and
drops as one device), each rank fills and runs only its E / n experts'
rows, and the combine's partial sums are summed over the axis. `forward`
and `loss_fn` take the TP group of the attention (the same axis).

Data parallelism: where each data rank holds its rows of the batch
(`data_group`), the capacity, the choice-priority slots and the aux loss's
fractions are still the whole batch's, as JAX computes them under one jit
over the global batch: each layer all-gathers the ranks' [k, E] routing
counts (`_tallies`), which place this rank's entries in the global order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fa2_triton_tpu_torch.models import llama
from fa2_triton_tpu_torch.models.llama import (
    LlamaConfig, LlamaLayer, LlamaModel, attention_block, make_attention_fn, rms_norm,
    rope_cos_sin,
)
from fa2_triton_tpu_torch.parallel.mesh import AXIS_MODEL, Spec, _table_specs


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # Per-expert capacity = ceil(top_k * tokens / n_experts * capacity_factor).
    capacity_factor: float = 1.25
    # Switch-transformer load-balancing aux loss coefficient.
    router_aux_coef: float = 0.01


def init_params(generator: torch.Generator, cfg: MoEConfig, device=None) -> LlamaModel:
    """Random MoE model (`llama.init_params`' distribution: router and
    experts N(0, 1/fan_in), the router fp32)."""
    if not isinstance(cfg, MoEConfig):
        raise TypeError(f"an MoE model needs an MoEConfig, got {type(cfg).__name__}")
    return llama.init_params(generator, cfg, device)


def _route(h2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Router: fp32 logits -> (top-k weights [T, k] renormalized to sum to
    1, expert indices [T, k], probabilities [T, E])."""
    probs = torch.softmax(h2d.float() @ router, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return weights / weights.sum(dim=-1, keepdim=True), idx, probs


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor)
    return max(int(c), 1)


def _tallies(idx: torch.Tensor, n_experts: int, data_group=None) -> Tuple[torch.Tensor, int]:
    """The routing's tallies over the whole batch: each data rank's count of
    the entries of each (choice j, expert e) [n, k, E], in data-rank order,
    and this rank's place in it. The batch's rows are cut over `data_group`
    in rank order (rank d holds the d-th block), so these counts place this
    rank's entries among the whole batch's: JAX computes the capacity, the
    slots and the aux loss's fractions over the global batch. Without a
    group, n is 1 and the place 0."""
    counts = F.one_hot(idx, n_experts).sum(dim=0)[None]                  # [1, k, E]
    if data_group is None:
        return counts, 0
    from fa2_triton_tpu_torch.parallel.collectives import all_gather, group_rank

    return all_gather(counts, data_group, dim=0), group_rank(data_group)


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, cfg: MoEConfig,
              tallies: Optional[Tuple[torch.Tensor, int]] = None) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e fraction_e * importance_e /
    top_k. The fraction counts indices, so only the importance carries a
    gradient (to the router). Over data ranks (`tallies` of `_tallies`) the
    fraction is the whole batch's and the importance this rank's rows':
    the mean over the ranks is the whole batch's loss (equal rows a rank)."""
    E = cfg.n_experts
    counts = (tallies or _tallies(idx, E))[0]
    fraction = counts.sum(dim=(0, 1)).float() / (idx.shape[0] * counts.shape[0])
    importance = probs.mean(dim=0)
    return E * torch.sum(fraction * importance) / cfg.top_k


def _slots(idx: torch.Tensor, n_experts: int, capacity: int,
           tallies: Optional[Tuple[torch.Tensor, int]] = None):
    """Choice-priority slots: the choices [T, k] flattened j-major (entry j
    * T + t is token t's j-th choice), each entry's position among the
    earlier entries of its expert, and whether that position is under
    `capacity`. Returns (experts [kT], positions [kT], keep [kT]). Over data
    ranks (`tallies` of `_tallies`) the order is the whole batch's, j-major
    over all its tokens: before this rank's j-th choices come every rank's
    earlier choices and the lower ranks' j-th."""
    T, k = idx.shape
    counts, d = tallies or _tallies(idx, n_experts)
    total = counts.sum(dim=0)                                              # [k, E]
    before = total.cumsum(dim=0) - total + counts[:d].sum(dim=0)           # [k, E]
    experts = idx.t().reshape(-1)
    hot = F.one_hot(idx.t(), n_experts)                                    # [k, T, E]
    pos = hot.cumsum(dim=1).gather(2, idx.t()[..., None])[..., 0] - 1      # within choice j
    pos = (pos + before.gather(1, idx.t())).reshape(-1)
    return experts, pos, pos < capacity


def _dispatch(layer: LlamaLayer, x: torch.Tensor, cfg: MoEConfig, capacity: Optional[int],
              data_group):
    """The replicated half of the block: the normed tokens h [T, dim], the
    routing weights [T, k], each entry's expert, slot and keep (`_slots`),
    the capacity C and the aux loss, over the whole batch of the data ranks
    when `data_group` is given."""
    T = x.shape[0] * x.shape[1]
    h = rms_norm(x, layer.mlp_norm, cfg.norm_eps).reshape(T, x.shape[2])
    weights, idx, probs = _route(h, layer.router, cfg)
    tallies = _tallies(idx, cfg.n_experts, data_group)
    C = _capacity(cfg, T * tallies[0].shape[0]) if capacity is None else capacity
    experts, pos, keep = _slots(idx, cfg.n_experts, C, tallies)
    return h, weights, experts, pos, keep, C, _aux_loss(probs, idx, cfg, tallies)


def _experts(layer: LlamaLayer, xs: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: xs [E, n, dim] -> [E, n, dim]."""
    gated = F.silu(torch.matmul(xs, layer.we_gate)) * torch.matmul(xs, layer.we_up)
    return torch.matmul(gated, layer.we_down)


def moe_mlp(layer: LlamaLayer, x: torch.Tensor, cfg: MoEConfig,
            capacity: Optional[int] = None, data_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse MoE MLP block (pre-norm, residual). Returns (out, aux_loss).

    Entry j * T + t (token t's j-th choice) goes to row `expert * C +
    slot` of the experts' buffers [E * C, dim] (a kept entry's row is its
    own; every dropped entry goes to one extra row that no expert reads).
    The combine gathers each entry's expert output (0 for a dropped one),
    scales it by its routing weight rounded to the activations' dtype (JAX's
    `comb.astype(ys.dtype)`), and sums a token's k entries in fp32. On a
    data rank (`data_group`, x this rank's rows) the capacity, slots and aux
    loss are the whole batch's (`_dispatch`)."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    h, weights, experts, pos, keep, C, aux = _dispatch(layer, x, cfg, capacity, data_group)
    rows = torch.where(keep, experts * C + pos, E * C)
    xs = h.new_zeros(E * C + 1, D).index_copy(0, rows, h.repeat(k, 1))
    ys = _experts(layer, xs[:-1].view(E, C, D)).reshape(E * C, D)
    ys = torch.cat([ys, ys.new_zeros(1, D)])[rows]
    comb = weights.t().reshape(-1).to(ys.dtype).float()
    out = (comb[:, None] * ys.float()).view(k, T, D).sum(dim=0)
    return x + out.reshape(B, S, D).to(x.dtype), aux


def moe_mlp_dense(layer: LlamaLayer, x: torch.Tensor, cfg: MoEConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense oracle of `moe_mlp`: every expert on every token, combined with
    the renormalized top-k weights. O(E) the work, but independent of what
    else shares the batch, so the serving paths use it; equal to `moe_mlp`
    when capacity suffices."""
    B, S, D = x.shape
    T = B * S
    h = rms_norm(x, layer.mlp_norm, cfg.norm_eps).reshape(T, D)
    weights, idx, probs = _route(h, layer.router, cfg)
    ys = _experts(layer, h.expand(cfg.n_experts, T, D))                    # [E, T, D]
    w_full = torch.zeros(T, cfg.n_experts, dtype=torch.float32, device=x.device)
    w_full = w_full.scatter_add(1, idx, weights)
    out = torch.einsum("te,etd->td", w_full.to(ys.dtype), ys)
    return x + out.reshape(B, S, D).to(x.dtype), _aux_loss(probs, idx, cfg)


def make_ep_mlp(mesh, axis: str = AXIS_MODEL) -> Callable:
    """Expert parallelism over `axis` of `mesh` (JAX l.176-211): an
    `mlp_fn` for a layer whose `we_*` hold this rank's E / n experts
    (`moe_param_pspecs`; rank i of the axis holds experts i * E / n ..).

    Routing, capacity and the choice-priority slots are computed replicated
    from the replicated router, so every rank sees one device's slots and
    drops. Each rank copies into its experts' buffers only the kept entries
    of its experts, runs them, and combines their rows; the partial sums
    [T, dim] are summed over the axis (Megatron's g). The tokens and the
    routing weights enter the local compute through f (`copy_to_group`), so
    their gradients, and the router's, are the sum of every rank's part. The
    aux loss is computed replicated and counted once. With a `data_group`
    (x this data rank's rows) the routing is the whole batch's, as in
    `moe_mlp`."""
    from fa2_triton_tpu_torch.parallel.collectives import all_reduce, copy_to_group
    from fa2_triton_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis) if n > 1 else None
    rank = axis_rank(mesh, axis)

    def mlp_fn(layer: LlamaLayer, x: torch.Tensor, cfg: MoEConfig,
               capacity: Optional[int] = None, data_group=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if cfg.n_experts % n:
            raise ValueError(f"{cfg.n_experts} experts do not split over {n} '{axis}' ranks")
        B, S, D = x.shape
        T, k, El = B * S, cfg.top_k, cfg.n_experts // n
        if layer.we_gate.shape[0] != El:
            raise ValueError(f"the layer holds {layer.we_gate.shape[0]} experts, a rank of {n} "
                             f"holds {El}: shard it with moe_param_pspecs")
        h, weights, experts, pos, keep, C, aux = _dispatch(layer, x, cfg, capacity, data_group)
        local = experts - rank * El
        mine = keep & (local >= 0) & (local < El)
        rows = torch.where(mine, local * C + pos, El * C)
        h_in, w_in = copy_to_group(h, group), copy_to_group(weights, group)
        xs = h.new_zeros(El * C + 1, D).index_copy(0, rows, h_in.repeat(k, 1))
        ys = _experts(layer, xs[:-1].view(El, C, D)).reshape(El * C, D)
        ys = torch.cat([ys, ys.new_zeros(1, D)])[rows]
        comb = w_in.t().reshape(-1).to(ys.dtype).float()
        out = (comb[:, None] * ys.float()).view(k, T, D).sum(dim=0)
        if group is not None:
            out = all_reduce(out, group)
        return x + out.reshape(B, S, D).to(x.dtype), aux

    return mlp_fn


# JAX `models/moe.py:_MOE_TP_TABLE`: attention TP over heads, experts on E,
# the router replicated; every other leaf (embedding, norms, lm_head) too.
_MOE_TP_TABLE: Dict[str, Spec] = {
    "wq": (None, AXIS_MODEL),
    "wk": (None, AXIS_MODEL),
    "wv": (None, AXIS_MODEL),
    "wo": (AXIS_MODEL, None),
    "router": (None, None),
    "we_gate": (AXIS_MODEL, None, None),
    "we_up": (AXIS_MODEL, None, None),
    "we_down": (AXIS_MODEL, None, None),
}


def moe_param_pspecs(model) -> Dict[str, Spec]:
    """Expert-parallel specs (JAX l.273-295) by parameter name: the
    stacked-E axis of each expert weight over `model`, attention over
    heads, everything else replicated. n_experts must be a multiple of the
    axis."""
    return _table_specs(model, _MOE_TP_TABLE)


def forward(
    model: LlamaModel,
    tokens: torch.Tensor,                 # [B, S] int
    attention_fn: Optional[Callable] = None,
    return_aux: bool = False,
    mlp_fn: Callable = moe_mlp,
    tp_group=None,
    gather_fn: Optional[Callable] = None,
    data_group=None,
):
    """Training forward -> logits [B, S, vocab] (fp32), and with
    `return_aux` the router aux loss summed over layers. `cfg.remat`
    checkpoints each layer (attention and MLP) under grad. `tp_group` and
    `gather_fn` as in `llama.forward`: over a TP group the attention is
    the rank's heads (`moe_param_pspecs`, with `make_ep_mlp` on the same
    axis as `mlp_fn`). With `data_group`, `tokens` are this data rank's rows
    of the batch and `mlp_fn` routes over the whole batch (`moe_mlp`)."""
    cfg = model.cfg
    route_kw = {"data_group": data_group} if data_group is not None else {}
    top = gather_fn(model) if gather_fn is not None else model
    B, S = tokens.shape
    x = top.embed[tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)

    def block(layer, x, fn):
        if gather_fn is not None:
            layer = gather_fn(layer)
        return mlp_fn(layer, attention_block(layer, x, cfg, cos, sin, fn, tp_group), cfg,
                      **route_kw)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, layer in enumerate(model.layers):
        fn = attention_fn if attention_fn is not None else make_attention_fn(cfg, li)
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(block, layer, x, fn, use_reentrant=False)
        else:
            x, a = block(layer, x, fn)
        aux = aux + a
    x = rms_norm(x, top.final_norm, cfg.norm_eps)
    logits = llama._head_logits(x, top, cfg, tp_group)
    return (logits, aux) if return_aux else logits


def loss_fn(model: LlamaModel, tokens: torch.Tensor,
            attention_fn: Optional[Callable] = None, mlp_fn: Callable = moe_mlp,
            tp_group=None, gather_fn: Optional[Callable] = None,
            data_group=None) -> torch.Tensor:
    """Next-token cross-entropy + router_aux_coef x the summed aux loss
    (`mlp_fn`, `tp_group`, `gather_fn`, `data_group` as in `forward`)."""
    logits, aux = forward(model, tokens[:, :-1], attention_fn, return_aux=True, mlp_fn=mlp_fn,
                          tp_group=tp_group, gather_fn=gather_fn, data_group=data_group)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    return nll + model.cfg.router_aux_coef * aux
