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

Expert parallelism (`make_ep_mlp`, `moe_param_pspecs`) is not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fa2_triton_tpu_torch.models import llama
from fa2_triton_tpu_torch.models.llama import (
    LlamaConfig, LlamaLayer, LlamaModel, attention_block, make_attention_fn, rms_norm,
    rope_cos_sin,
)


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


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e fraction_e * importance_e /
    top_k. The fraction counts indices, so only the importance carries a
    gradient (to the router)."""
    E = cfg.n_experts
    fraction = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    importance = probs.mean(dim=0)
    return E * torch.sum(fraction * importance) / cfg.top_k


def _slots(idx: torch.Tensor, n_experts: int, capacity: int):
    """Choice-priority slots: the choices [T, k] flattened j-major (entry j
    * T + t is token t's j-th choice), each entry's position among the
    earlier entries of its expert, and whether that position is under
    `capacity`. Returns (experts [kT], positions [kT], keep [kT])."""
    experts = idx.t().reshape(-1)
    pos = F.one_hot(experts, n_experts).cumsum(dim=0).gather(1, experts[:, None])[:, 0] - 1
    return experts, pos, pos < capacity


def _experts(layer: LlamaLayer, xs: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: xs [E, n, dim] -> [E, n, dim]."""
    gated = F.silu(torch.matmul(xs, layer.we_gate)) * torch.matmul(xs, layer.we_up)
    return torch.matmul(gated, layer.we_down)


def moe_mlp(layer: LlamaLayer, x: torch.Tensor, cfg: MoEConfig,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse MoE MLP block (pre-norm, residual). Returns (out, aux_loss).

    Entry j * T + t (token t's j-th choice) goes to row `expert * C +
    slot` of the experts' buffers [E * C, dim] (a kept entry's row is its
    own; every dropped entry goes to one extra row that no expert reads).
    The combine gathers each entry's expert output (0 for a dropped one),
    scales it by its routing weight rounded to the activations' dtype (JAX's
    `comb.astype(ys.dtype)`), and sums a token's k entries in fp32."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    C = _capacity(cfg, T) if capacity is None else capacity
    h = rms_norm(x, layer.mlp_norm, cfg.norm_eps).reshape(T, D)
    weights, idx, probs = _route(h, layer.router, cfg)
    experts, pos, keep = _slots(idx, E, C)
    rows = torch.where(keep, experts * C + pos, E * C)
    xs = h.new_zeros(E * C + 1, D).index_copy(0, rows, h.repeat(k, 1))
    ys = _experts(layer, xs[:-1].view(E, C, D)).reshape(E * C, D)
    ys = torch.cat([ys, ys.new_zeros(1, D)])[rows]
    comb = weights.t().reshape(-1).to(ys.dtype).float()
    out = (comb[:, None] * ys.float()).view(k, T, D).sum(dim=0)
    return x + out.reshape(B, S, D).to(x.dtype), _aux_loss(probs, idx, cfg)


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


def make_ep_mlp(*args, **kwargs):
    raise NotImplementedError("expert parallelism over a mesh is not ported yet "
                              "(ROADMAP.md queue A.7(ii))")


def moe_param_pspecs(*args, **kwargs):
    raise NotImplementedError("expert-parallel sharding specs are not ported yet "
                              "(ROADMAP.md queue A.7(ii))")


def forward(
    model: LlamaModel,
    tokens: torch.Tensor,                 # [B, S] int
    attention_fn: Optional[Callable] = None,
    return_aux: bool = False,
    mlp_fn: Callable = moe_mlp,
):
    """Training forward -> logits [B, S, vocab] (fp32), and with
    `return_aux` the router aux loss summed over layers. `cfg.remat`
    checkpoints each layer (attention and MLP) under grad."""
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed[tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)

    def block(layer, x, fn):
        return mlp_fn(layer, attention_block(layer, x, cfg, cos, sin, fn), cfg)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, layer in enumerate(model.layers):
        fn = attention_fn if attention_fn is not None else make_attention_fn(cfg, li)
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(block, layer, x, fn, use_reentrant=False)
        else:
            x, a = block(layer, x, fn)
        aux = aux + a
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = llama._logits(x, model, cfg)
    return (logits, aux) if return_aux else logits


def loss_fn(model: LlamaModel, tokens: torch.Tensor,
            attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy + router_aux_coef x the summed aux loss."""
    logits, aux = forward(model, tokens[:, :-1], attention_fn, return_aux=True)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    return nll + model.cfg.router_aux_coef * aux
