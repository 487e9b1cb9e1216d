"""Device meshes and the parameter spec tables (port of
`fa2_triton_tpu/parallel/mesh.py`).

The JAX package names a `jax.sharding.Mesh` over the canonical axes
    data  — batch (DP)
    model — attention heads / MLP hidden (TP)
    seq   — sequence (ring / Ulysses context parallelism)
and a leading `pipe` axis when pipeline parallelism is asked for. The port
runs SPMD ranks over `torch.distributed`: `make_mesh` returns a
`DeviceMesh` with the same axis names in the same order, whose groups each
rank's collectives take (`parallel/collectives.py`). The groups are made
here, every one with a timeout, so a rank that is gone fails its peers'
calls instead of hanging them; the mesh holds groups only, and tensors may
live on the card or on the CPU.

A spec is what JAX writes as a `PartitionSpec`: a tuple of one axis name
(or None) per dim, `()` for a replicated leaf. The tables are keyed by the
parameter names of `models/llama.py:LlamaModel` (`layers.0.wq`, and
`layers.0.wq.qvalues` / `.qscale` for a weight-only quantized weight),
which keep the JAX tree's names, so a name maps to a JAX path one to one.
`shard_params` applies a table: it slices the full model into this rank's
local `LlamaModel`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"

Spec = Tuple[Optional[str], ...]
MeshLike = Union[DeviceMesh, Mapping[str, int]]

DEFAULT_GROUP_TIMEOUT_S = 300.0


def _groups_along(layout: np.ndarray, axis: int, timeout):
    """Make every group of ranks that differ only in `axis` (each rank takes
    part in every `new_group` call, in one order) and return this rank's."""
    moved = np.moveaxis(layout, axis, -1).reshape(-1, layout.shape[axis])
    me, mine = dist.get_rank(), None
    for ranks in moved:
        g = dist.new_group([int(r) for r in ranks], timeout=timeout)
        if me in ranks:
            mine = g
    return mine


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, pipe: int = 1,
              timeout_s: float = DEFAULT_GROUP_TIMEOUT_S) -> DeviceMesh:
    """A `DeviceMesh` over the ranks of the default process group, shaped
    (data, model, seq), or (pipe, data, model, seq) when pipe > 1 (JAX
    l.25-46: `pipe` slowest-varying, `model` / `seq` fastest). Its
    product must be the world size. Every axis's groups carry a timeout of
    `timeout_s`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: join one first "
                           "(parallel/launch.py: init_rank or spawn_ranks)")
    shape, names = (data, model, seq), (AXIS_DATA, AXIS_MODEL, AXIS_SEQ)
    if pipe > 1:
        shape, names = (pipe,) + shape, (AXIS_PIPE,) + names
    need = int(np.prod(shape))
    if need != dist.get_world_size():
        raise ValueError(f"a mesh of {dict(zip(names, shape))} needs {need} ranks, the world "
                         f"has {dist.get_world_size()}")
    layout = np.arange(need).reshape(shape)
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = [_groups_along(layout, a, timeout) for a in range(len(shape))]
    return DeviceMesh.from_group(groups, "cpu", mesh=torch.from_numpy(layout),
                                 mesh_dim_names=names)


def make_multihost_mesh(model: int = 1, seq: int = 1, local_world: Optional[int] = None,
                        timeout_s: float = DEFAULT_GROUP_TIMEOUT_S) -> DeviceMesh:
    """The mesh of a deployment over several hosts (JAX l.49-71): `data`
    outermost, across hosts, and `model` / `seq` within one host, so their
    per-layer collectives never leave it. Ranks are numbered host by host
    (as torchrun numbers them), so a (data, model, seq) layout of the world
    in rank order puts each model x seq block on one host. `local_world` is
    the ranks a host runs (default: torchrun's LOCAL_WORLD_SIZE, else the
    whole world, one host); model * seq must divide it."""
    world = dist.get_world_size()
    n_local = local_world or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    per_host = model * seq
    if n_local % per_host:
        raise ValueError(f"model*seq = {per_host} must divide the {n_local} ranks per host "
                         "so TP/SP collectives never leave a host")
    return make_mesh(data=world // per_host, model=model, seq=seq, timeout_s=timeout_s)


def axis_size(mesh: Optional[MeshLike], name: str) -> int:
    """The size of axis `name` (1 when the mesh has no such axis, or no
    mesh); `mesh` may be a `DeviceMesh` or a {name: size} mapping."""
    if mesh is None:
        return 1
    if isinstance(mesh, Mapping):
        return int(mesh.get(name, 1))
    names = mesh.mesh_dim_names or ()
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return {k: int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def axis_rank(mesh: Optional[MeshLike], name: str) -> int:
    """This rank's index along axis `name` (0 without such an axis)."""
    if mesh is None or isinstance(mesh, Mapping) or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh: DeviceMesh, name: str):
    """The process group of this rank along axis `name`."""
    return mesh.get_group(name)


def axis_groups(mesh: DeviceMesh) -> Dict[str, object]:
    return {name: mesh.get_group(name) for name in mesh.mesh_dim_names}


_TP_TABLE: Dict[str, Spec] = {
    "wq": (None, AXIS_MODEL),
    "wk": (None, AXIS_MODEL),
    "wv": (None, AXIS_MODEL),
    "wo": (AXIS_MODEL, None),
    # Qwen2-style qkv biases [n_heads * hd]: sharded like their projection's
    # output dim.
    "bq": (AXIS_MODEL,),
    "bk": (AXIS_MODEL,),
    "bv": (AXIS_MODEL,),
    "w_gate": (None, AXIS_MODEL),
    "w_up": (None, AXIS_MODEL),
    "w_down": (AXIS_MODEL, None),
    "embed": (None, None),
}


def _spec_from_path(path: Tuple[str, ...], table: Mapping[str, Spec]) -> Spec:
    """The spec of a leaf (JAX l.91-103): by its own name, except that a
    quantized weight's `qvalues` take the weight's spec and its [1, out]
    `qscale` shards only along the output dim."""
    name = path[-1]
    if name in ("qvalues", "qscale") and len(path) >= 2:
        wspec = table.get(path[-2], ())
        if name == "qvalues":
            return wspec
        return (None, wspec[1] if len(wspec) > 1 else None)
    return table.get(name, ())


def named_leaves(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{dotted name: tensor} of every parameter and buffer of `model` (a
    `QuantizedWeight`'s two buffers as `<weight>.qvalues` / `.qscale`)."""
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


def _table_specs(model, table) -> Dict[str, Spec]:
    return {name: _spec_from_path(tuple(name.split(".")), table)
            for name in named_leaves(model)}


def param_pspecs(model) -> Dict[str, Spec]:
    """Training TP specs (JAX l.106-118): wq / wk / wv and the MLP's gate /
    up shard their output dim over `model`, wo and w_down their input dim,
    lm_head its vocab; the embedding, norms and everything else are
    replicated."""
    return _table_specs(model, dict(_TP_TABLE, lm_head=(None, AXIS_MODEL)))


def serving_param_pspecs(model) -> Dict[str, Spec]:
    """Serving TP specs (JAX l.121-129): `param_pspecs` with lm_head
    replicated, so every rank computes the whole vocab's logits and picks
    the same token with no gather."""
    return _table_specs(model, dict(_TP_TABLE, lm_head=(None, None)))


def fsdp_param_pspecs(model, mesh: Optional[MeshLike] = None, axis: str = AXIS_DATA,
                      min_size: int = 2 ** 14,
                      base: Optional[Mapping[str, Spec]] = None) -> Dict[str, Spec]:
    """ZeRO-3 / FSDP specs (JAX l.136-176): every leaf of at least
    `min_size` elements shards one dim over `axis`, the largest whose
    extent the axis divides (any, without a mesh), skipping a dim TP
    already shards; smaller leaves, and leaves no dim of which divides, stay
    as they are. With a `model` axis above 1 the weights keep their TP
    spec first (ZeRO-3 over the TP shards): `param_pspecs`' table, or the
    specs `base` names (an MoE model's `models/moe.py:moe_param_pspecs`)."""
    n = axis_size(mesh, axis) if mesh is not None else None
    tp = axis_size(mesh, AXIS_MODEL)
    tp_table = dict(_TP_TABLE, lm_head=(None, AXIS_MODEL)) if tp > 1 else {}
    out = {}
    for name, leaf in named_leaves(model).items():
        if tp == 1:
            tp_spec = ()
        elif base is not None:
            tp_spec = tuple(base.get(name, ()))
        else:
            tp_spec = _spec_from_path(tuple(name.split(".")), tp_table)
        spec = tp_spec
        if leaf.dim() >= 1 and leaf.numel() >= min_size:
            for d in sorted(range(leaf.dim()), key=lambda d: -leaf.shape[d]):
                if len(tp_spec) > d and tp_spec[d] is not None:
                    continue   # already TP-sharded
                if n is None or leaf.shape[d] % n == 0:
                    spec = tuple(tp_spec[i] if i < len(tp_spec) else None
                                 for i in range(leaf.dim()))
                    spec = spec[:d] + (axis,) + spec[d + 1:]
                    break
        out[name] = spec
    return out


def shard_tensor(x: torch.Tensor, spec: Spec, mesh: MeshLike,
                 coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """This rank's piece of the full tensor x under `spec` (a contiguous
    copy where a dim is cut, x itself where none is). `coords` overrides
    this rank's index per axis (default: its place in `mesh`)."""
    out = x
    for d, name in enumerate(spec):
        n = axis_size(mesh, name) if name is not None else 1
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over {n} '{name}' ranks")
        i = coords[name] if coords is not None and name in coords else axis_rank(mesh, name)
        step = x.shape[d] // n
        out = out.narrow(d, i * step, step)
    return out if out is x else out.contiguous()


def local_config(cfg, tp: int):
    """The config a TP rank computes with (JAX `runtime/serving.py:
    cfg_local`): its share of the q and kv heads, the head dim fixed."""
    if tp == 1:
        return cfg
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"n_heads {cfg.n_heads} and n_kv_heads {cfg.n_kv_heads} must be "
                         f"multiples of the model axis {tp}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                               head_dim=cfg.hd)


@torch.no_grad()
def shard_params(model, mesh: MeshLike, specs: Optional[Mapping[str, Spec]] = None,
                 coords: Optional[Mapping[str, int]] = None):
    """This rank's local model (JAX l.132-136 places the whole tree; an SPMD
    rank keeps only its piece): a shallow copy of `model` (a `LlamaModel`)
    whose every leaf is cut by its spec (`param_pspecs` by default) at this
    rank's place in `mesh` (or `coords`), and whose config carries the local
    head counts when the `model` axis cuts the heads. Leaves that are not
    cut are shared with `model`; a weight-only quantized weight is cut as a
    new `QuantizedWeight`."""
    from fa2_triton_tpu_torch.models.llama import replace_weight, shallow_copy
    from fa2_triton_tpu_torch.ops.quant import QuantizedWeight

    specs = param_pspecs(model) if specs is None else specs

    def cut(x, name):
        return shard_tensor(x, specs.get(name, ()), mesh, coords)

    out = shallow_copy(model)
    owners = [("", out)] + [(f"layers.{i}.", layer) for i, layer in enumerate(out.layers)]
    for prefix, module in owners:
        for attr, w in list(module._parameters.items()):
            piece = cut(w, prefix + attr) if w is not None else w
            if piece is not w:
                replace_weight(module, attr, torch.nn.Parameter(piece, w.requires_grad))
        for attr, sub in list(module._modules.items()):
            if isinstance(sub, QuantizedWeight):
                qv = cut(sub.qvalues, f"{prefix}{attr}.qvalues")
                qs = cut(sub.qscale, f"{prefix}{attr}.qscale")
                if qv is not sub.qvalues or qs is not sub.qscale:
                    replace_weight(module, attr, QuantizedWeight(qv, qs))
    heads_cut = any(AXIS_MODEL in spec for name, spec in specs.items()
                    if name.endswith((".wq", ".wq.qvalues")))
    out.cfg = local_config(model.cfg, axis_size(mesh, AXIS_MODEL)) if heads_cut else model.cfg
    return out
