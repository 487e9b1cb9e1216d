"""The port's parallel layer over `torch.distributed` (counterpart of
`fa2_triton_tpu.parallel`): meshes and spec tables, TP / ring / Ulysses
attention, and the collectives and rank launcher they run on. The
pipeline (`pipeline.py`) and FSDP training wait for ROADMAP.md queue A.7(ii)."""
from fa2_triton_tpu_torch.parallel.attention import make_tp_attention
from fa2_triton_tpu_torch.parallel.launch import init_rank, spawn_ranks
from fa2_triton_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ, fsdp_param_pspecs, make_mesh,
    make_multihost_mesh, param_pspecs, serving_param_pspecs, shard_params,
)
from fa2_triton_tpu_torch.parallel.ring import make_ring_attention, ring_attention_local
from fa2_triton_tpu_torch.parallel.ulysses import make_ulysses_attention, ulysses_attention_local

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "AXIS_PIPE", "AXIS_SEQ",
    "make_mesh", "make_multihost_mesh", "param_pspecs", "serving_param_pspecs",
    "fsdp_param_pspecs", "shard_params",
    "make_tp_attention", "make_ring_attention", "ring_attention_local",
    "make_ulysses_attention", "ulysses_attention_local",
    "init_rank", "spawn_ranks",
]
