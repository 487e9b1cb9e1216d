"""Head-tensor-parallel and data-parallel attention (port of
`fa2_triton_tpu/parallel/attention.py`).

Attention is embarrassingly parallel over (batch, head): each rank runs the
unmodified `flash_attn_func` on its batch shard (`data` axis) and head
shard (`model` axis), with no collective inside attention; the projections
around it reduce over `model` (`models/llama.py`'s `tp_group`). Hq and Hkv
must be multiples of the model axis, so every rank keeps whole GQA groups.
"""
from __future__ import annotations

from typing import Optional, Tuple

from fa2_triton_tpu_torch.ops.attention import flash_attn_func
from fa2_triton_tpu_torch.parallel import collectives as coll
from fa2_triton_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, axis_groups

SPEC = (AXIS_DATA, None, AXIS_MODEL, None)


def make_tp_attention(
    mesh,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
):
    """Returns a differentiable fn(q, k, v) over GLOBAL [B, S, H, D]
    tensors, the same on every rank of `mesh`: each rank attends its
    (batch, head) piece, spec (data, None, model, None), and the output is
    gathered, so every rank returns the whole [B, S, Hq, D]."""
    groups = axis_groups(mesh)

    def fn(q, k, v):
        local = [coll.shard(x, SPEC, groups) for x in (q, k, v)]
        out = flash_attn_func(*local, causal=causal, softmax_scale=softmax_scale,
                              window_size=window_size, softcap=softcap)
        return coll.gather(out, SPEC, groups)

    return fn
