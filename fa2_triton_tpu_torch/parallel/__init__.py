"""The port's parallel layer over `torch.distributed` (counterpart of
`fa2_triton_tpu.parallel`): meshes and spec tables, TP / ring / Ulysses
attention, the GPipe and 3-D pipelines (`pipeline.py`), training over a
(data, model) mesh with FSDP / ZeRO-3 (`fsdp.py`), the collectives and
rank launcher they run on, and `dryrun.py:dryrun_multichip`."""
from fa2_triton_tpu_torch.parallel.attention import make_tp_attention
from fa2_triton_tpu_torch.parallel.fsdp import FSDP, train_specs
from fa2_triton_tpu_torch.parallel.launch import init_rank, spawn_ranks
from fa2_triton_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ, fsdp_param_pspecs, make_mesh,
    make_multihost_mesh, param_pspecs, serving_param_pspecs, shard_params,
)
from fa2_triton_tpu_torch.parallel.pipeline import (
    make_llama_3d_forward, make_llama_pipeline_forward, make_pipeline, pipeline_params_from_llama,
    shard_stacked_layers, stack_layer_params,
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
    "stack_layer_params", "shard_stacked_layers", "make_pipeline", "make_llama_pipeline_forward",
    "make_llama_3d_forward", "pipeline_params_from_llama", "FSDP", "train_specs",
]
