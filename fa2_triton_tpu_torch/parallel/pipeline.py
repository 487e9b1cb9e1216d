"""Pipeline parallelism (GPipe) over the mesh's `pipe` axis (port of
`fa2_triton_tpu/parallel/pipeline.py`).

JAX runs the schedule as one `lax.scan` inside `shard_map`, and reverse-mode
AD transposes its `ppermute`s into the mirrored backward pipeline. The port
runs the same schedule on SPMD ranks, one stage a rank of the `pipe` group:

Schedule: M microbatches through P stages in M + P - 1 ticks. Every tick
each stage applies its layers to the activation it holds and passes the
result one hop on (`collectives.ring_pass`); stage 0 takes microbatch t,
the last stage banks microbatch t - (P - 1). Bubbles compute on zeros (or
on a microbatch that never reaches the bank) and are masked out, and a
masked sum over `pipe` replicates the result.

The backward is autograd through that forward: `ring_pass`'s backward sends
each cotangent one hop back, as JAX's transpose of `ppermute` does. Since
an SPMD rank runs the backward of only what its own loss reaches, each
rank selects between the microbatch and the received activation, and
between a banked output and a new one, with `torch.where` on its stage
index, never with a branch: then every rank's graph holds every hop, every
rank runs every hop's backward, and the peers meet in each. The stages'
replicated input enters through Megatron's f (`copy_to_group`), so its
gradient, which only stage 0 computes, reaches every rank; the final sum
over `pipe` is `all_reduce`, whose backward is the identity.

Layer-to-stage mapping: the layers' parameters are stacked on a leading
axis (`stack_layer_params`) and cut over `pipe` (`shard_stacked_layers`):
a stage rank holds only its L / P consecutive layers. The embedding and
the LM head run replicated outside the pipelined region.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import torch

from fa2_triton_tpu_torch.parallel import collectives as coll
from fa2_triton_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, AXIS_PIPE, Spec, axis_group, axis_groups, axis_rank, axis_size,
    local_config, shard_tensor,
)

Params = Dict[str, Any]


def _leaves(layer) -> Dict[str, torch.Tensor]:
    """A layer's tensors by name: a dict as it is, a module's parameters."""
    if isinstance(layer, dict):
        return layer
    return {name: p for name, p in layer.named_parameters(recurse=False)}


def stack_layer_params(layers) -> Params:
    """[layer] * L -> {name: [L, ...]}: each tensor of the layers (dicts of
    tensors, or `LlamaLayer`s: their parameters) stacked on a leading axis,
    the one `pipe` cuts. Differentiable."""
    dicts = [_leaves(layer) for layer in layers]
    return {name: torch.stack([d[name] for d in dicts]) for name in dicts[0]}


def _stage_slice(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} layers do not split over {n} pipeline stages")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per].clone()


def shard_stacked_layers(stacked: Params, mesh) -> Params:
    """This rank's piece of a stacked-layer dict: layers i * L / P ..
    (i + 1) * L / P of each leaf for pipe rank i (JAX places the same
    slices, one a device)."""
    n, i = axis_size(mesh, AXIS_PIPE), axis_rank(mesh, AXIS_PIPE)
    return {name: _stage_slice(x, n, i) for name, x in stacked.items()}


def make_pipeline(mesh, stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                  n_microbatches: int, axis: str = AXIS_PIPE) -> Callable:
    """Build `pipeline(local_layers, xs) -> ys`.

    stage_fn(local_layers, x) applies this rank's stage to one microbatch
    activation [mb, ...] and must map zeros to finite values (pre-norm
    blocks do). `xs` is [M, mb, ...], the same on every rank of the `axis`
    group, and `ys` comes back the same shape on every rank. Differentiable
    (see the module's docstring); every rank of the group must call it."""
    n_stages = axis_size(mesh, axis)
    group = axis_group(mesh, axis) if n_stages > 1 else None
    idx = axis_rank(mesh, axis)
    M = n_microbatches

    def pipeline(local_layers: Params, xs: torch.Tensor) -> torch.Tensor:
        if xs.shape[0] != M:
            raise ValueError(f"xs holds {xs.shape[0]} microbatches, the pipeline {M}")
        if group is None:
            return torch.stack([stage_fn(local_layers, xs[m]) for m in range(M)])
        xs = coll.copy_to_group(xs, group)
        first = torch.tensor(idx == 0, device=xs.device)
        last = torch.tensor(idx == n_stages - 1, device=xs.device)
        state = torch.zeros_like(xs[0])
        banked = [torch.zeros_like(xs[0]) for _ in range(M)]
        ticks = M + n_stages - 1
        for t in range(ticks):
            inp = torch.where(first, xs[min(t, M - 1)], state)
            out = stage_fn(local_layers, inp)
            m = t - (n_stages - 1)
            if m >= 0:
                banked[m] = torch.where(last, out, banked[m])
            if t < ticks - 1:    # the last hop's result is read by no stage
                state = coll.ring_pass(out, group)
        ys = torch.stack(banked)
        # The results live on the last stage; a masked sum replicates them.
        return coll.all_reduce(torch.where(last, ys, torch.zeros_like(ys)), group)

    return pipeline


class _LayerView:
    """One layer of a stacked dict: `view.wq` is leaf "wq" at layer i, and a
    name the dict lacks (bq, q_norm, router, ...) is None, as the absent
    optional parameters of a `LlamaLayer` are."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.__dict__["_t"] = tensors

    def __getattr__(self, name):
        return self.__dict__["_t"].get(name)


def _layers_of(stacked: Params) -> Iterator[_LayerView]:
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        yield _LayerView({name: x[i] for name, x in stacked.items()})


def _uniform_window(cfg) -> bool:
    """Every layer has the same window (JAX `LlamaConfig.uniform_window`)."""
    return len({cfg.window_for(i) for i in range(cfg.n_layers)}) == 1


def _stage_layers(cfg, attention_fn, tp_group=None) -> Callable:
    """stage_fn of the LLaMA pipelines: the stage's layers in order
    (`models/llama.py:_layer`, remat per layer with `cfg.remat`)."""
    from torch.utils.checkpoint import checkpoint

    from fa2_triton_tpu_torch.models.llama import _layer, rope_cos_sin

    def stage_fn(local_layers: Params, x: torch.Tensor) -> torch.Tensor:
        mb, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(mb, S)
        cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
        for layer in _layers_of(local_layers):
            args = (layer, x, cfg, cos, sin, attention_fn, tp_group)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_layer, *args, use_reentrant=False)
            else:
                x = _layer(*args)
        return x

    return stage_fn


def _head(pipe_params: Params, ys: torch.Tensor, cfg) -> torch.Tensor:
    from fa2_triton_tpu_torch.models.llama import rms_norm

    ys = rms_norm(ys, pipe_params["final_norm"], cfg.norm_eps)
    return (ys @ pipe_params["lm_head"]).float()


def make_llama_pipeline_forward(mesh, cfg, n_microbatches: int,
                                attention_fn: Optional[Callable] = None) -> Callable:
    """LLaMA over the pipeline: `fn(pipe_params, tokens [B, S]) -> logits`
    [B, S, V] fp32, where `pipe_params` = {embed, stacked (this rank's
    stage), final_norm, lm_head} (`pipeline_params_from_llama`) and B splits
    into n_microbatches."""
    from fa2_triton_tpu_torch.models.llama import make_attention_fn

    # One attention function serves every layer of a stage (JAX scans the
    # layers), so a per-layer window would be applied wrongly: refuse it.
    assert _uniform_window(cfg), \
        "pipeline stages scan layers: alternating/per-layer windows unsupported"
    n_stages = axis_size(mesh, AXIS_PIPE)
    assert cfg.n_layers % n_stages == 0, (cfg.n_layers, n_stages)
    pipeline = make_pipeline(mesh, _stage_layers(cfg, attention_fn or make_attention_fn(cfg)),
                             n_microbatches)

    def forward(pipe_params: Params, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        assert B % n_microbatches == 0, (B, n_microbatches)
        x = pipe_params["embed"][tokens]
        xs = x.reshape(n_microbatches, B // n_microbatches, S, -1)
        ys = pipeline(pipe_params["stacked"], xs).reshape(B, S, -1)
        return _head(pipe_params, ys, cfg)

    return forward


_3D_TABLE: Dict[str, Spec] = {
    "wq": (AXIS_PIPE, None, AXIS_MODEL),
    "wk": (AXIS_PIPE, None, AXIS_MODEL),
    "wv": (AXIS_PIPE, None, AXIS_MODEL),
    "wo": (AXIS_PIPE, AXIS_MODEL, None),
    "w_gate": (AXIS_PIPE, None, AXIS_MODEL),
    "w_up": (AXIS_PIPE, None, AXIS_MODEL),
    "w_down": (AXIS_PIPE, AXIS_MODEL, None),
}


def _stacked_3d_specs(stacked: Params) -> Dict[str, Spec]:
    """Specs of the stacked leaves under pp x tp (JAX l.150-175): the layer
    axis on `pipe`, Megatron's head / hidden cut on `model` (wq / wk / wv /
    w_gate / w_up their output dim, wo / w_down their input dim), norms on
    `pipe` only."""
    return {name: _3D_TABLE.get(name, (AXIS_PIPE,)) for name in stacked}


def make_llama_3d_forward(mesh, cfg, n_microbatches: int) -> Callable:
    """pp x dp x tp (JAX l.178-292): the GPipe schedule over `pipe`, each
    microbatch's rows cut over `data`, and Megatron TP over `model` inside
    every stage (local heads through the flash kernels; f on the normed
    inputs, the wo / w_down partials summed). Returns `fn(pipe_params,
    tokens [B, S]) -> logits` [B, S, V], whole on every rank, with B a
    multiple of n_microbatches x data; build `pipe_params` with
    `pipeline_params_from_llama(model, mesh, tp=True)`.

    The stage's parameters enter through f over `data` (each data rank's
    gradient is its rows' part, summed), the rows are cut from the
    replicated embedding and gathered after the pipeline, and the head runs
    replicated, so every leaf's gradient is the whole batch's."""
    from fa2_triton_tpu_torch.models.llama import make_attention_fn

    n_stages = axis_size(mesh, AXIS_PIPE)
    tp, dp = axis_size(mesh, AXIS_MODEL), axis_size(mesh, AXIS_DATA)
    assert cfg.n_layers % n_stages == 0, (cfg.n_layers, n_stages)
    assert cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0, (cfg.n_heads, cfg.n_kv_heads, tp)
    assert _uniform_window(cfg), \
        "pipeline stages scan layers: alternating/per-layer windows unsupported"
    lcfg = local_config(cfg, tp)
    groups = axis_groups(mesh)
    data_group = groups[AXIS_DATA] if dp > 1 else None
    pipeline = make_pipeline(mesh, _stage_layers(lcfg, make_attention_fn(lcfg),
                                                 groups[AXIS_MODEL] if tp > 1 else None),
                             n_microbatches)
    rows = (None, AXIS_DATA)

    def forward(pipe_params: Params, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        assert B % n_microbatches == 0 and (B // n_microbatches) % dp == 0, \
            (B, n_microbatches, dp)
        x = pipe_params["embed"][tokens]
        xs = coll.shard(x.reshape(n_microbatches, B // n_microbatches, S, -1), rows, groups)
        stacked = {name: coll.copy_to_group(v, data_group)
                   for name, v in pipe_params["stacked"].items()}
        ys = coll.gather(pipeline(stacked, xs), rows, groups).reshape(B, S, -1)
        return _head(pipe_params, ys, cfg)

    return forward


def pipeline_params_from_llama(model, mesh=None, tp: bool = False) -> Params:
    """Repack a `LlamaModel` for the pipeline (JAX l.295-310): {embed,
    stacked, final_norm, lm_head}, the embedding, final norm and head being
    the model's own parameters. Without a mesh, `stacked` holds every
    layer; with one, this pipe rank's L / P layers only, and with `tp` also
    only its `model`-axis piece of each (`_stacked_3d_specs`), for
    `make_llama_3d_forward`. The stacked tensors are computed from the
    model's parameters, so gradients reach those."""
    layers = list(model.layers)
    if mesh is None:
        return {"embed": model.embed, "stacked": stack_layer_params(layers),
                "final_norm": model.final_norm, "lm_head": model.lm_head}
    n, i = axis_size(mesh, AXIS_PIPE), axis_rank(mesh, AXIS_PIPE)
    if len(layers) % n:
        raise ValueError(f"{len(layers)} layers do not split over {n} pipeline stages")
    per = len(layers) // n
    stacked = stack_layer_params(layers[i * per:(i + 1) * per])
    if tp:
        specs = _stacked_3d_specs(stacked)
        # The layer axis is already this stage's: cut the model axis only.
        stacked = {name: shard_tensor(x, tuple(None if a == AXIS_PIPE else a for a in specs[name]),
                                      mesh)
                   for name, x in stacked.items()}
    return {"embed": model.embed, "stacked": stacked, "final_norm": model.final_norm,
            "lm_head": model.lm_head}
