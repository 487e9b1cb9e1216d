"""Ulysses sequence parallelism: all-to-all between sequence and head
sharding (port of `fa2_triton_tpu/parallel/ulysses.py`).

The second sequence-parallel flavour beside `parallel/ring.py`. The
activations arrive sequence-sharded [B, S/n, H, D]; one all-to-all per
tensor makes them head-sharded [B, S, H/n, D]; each rank runs the
unmodified `flash_attn_func` over the whole sequence for its heads (causal
masks, windows and softcaps need nothing more); the output takes the
inverse all-to-all back to sequence sharding. Two all-to-alls of
activation size in all, but n must divide Hkv; the ring scales past the
head count. Both are exact. The all-to-alls are differentiable
(`parallel/collectives.py:all_to_all`), so the backward is the kernels'
own behind two more.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops.attention import flash_attn_func
from fa2_triton_tpu_torch.parallel import collectives as coll
from fa2_triton_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_SEQ, axis_groups


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group,
                            causal: bool = False, softmax_scale: Optional[float] = None,
                            window_size: Tuple[int, int] = (-1, -1),
                            softcap: float = 0.0) -> torch.Tensor:
    """Attention of this rank's sequence shard q [B, S/n, Hq, D], k / v
    [B, S/n, Hkv, D] over `group` (the seq axis's n ranks, in sequence
    order); returns out [B, S/n, Hq, D]. Rank j attends heads
    [j H/n, (j + 1) H/n) of the whole sequence; the heads come back
    g-major (h = g H/n + l), as JAX's tiled all-to-all lays them."""
    n = coll.group_size(group)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"Ulysses needs Hq {q.shape[2]} and Hkv {k.shape[2]} divisible by the "
                         f"seq axis {n}")
    # [B, S/n, H, D] -> [B, S, H/n, D]: rank j keeps head block j and
    # gathers every sequence chunk in source-rank (= sequence) order.
    heads = [coll.all_to_all(x, group, split_dim=2, concat_dim=1) for x in (q, k, v)]
    out = flash_attn_func(*heads, causal=causal, softmax_scale=softmax_scale,
                          window_size=window_size, softcap=softcap)
    return coll.all_to_all(out, group, split_dim=1, concat_dim=2)


def make_ulysses_attention(
    mesh,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    seq_axis: str = AXIS_SEQ,
):
    """Returns a differentiable fn(q, k, v) over GLOBAL [B, S, H, D]
    tensors, the same on every rank of `mesh`: each rank takes its
    (data, seq) piece, spec (data, seq, None, None), runs
    `ulysses_attention_local` over the seq group, and the output is
    gathered, so every rank returns the whole out. Same numbers as the
    single-device kernel on the whole tensors."""
    groups = axis_groups(mesh)
    spec = (AXIS_DATA, seq_axis, None, None)

    def fn(q, k, v):
        local = [coll.shard(x, spec, groups) for x in (q, k, v)]
        out = ulysses_attention_local(*local, group=groups[seq_axis], causal=causal,
                                      softmax_scale=softmax_scale, window_size=window_size,
                                      softcap=softcap)
        return coll.gather(out, spec, groups)

    return fn
