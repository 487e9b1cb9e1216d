"""FlashAttention-2 backward: the CUDA kernels' wrappers, their plain twins
and the causal routing.

Port of `fa2_triton_tpu/ops/flash_bwd.py:flash_attn_backward` as
`flash_attn_func`'s autograd reaches it. The TPU schedules B12
(`_bwd_causal_strip_kernel`, the seq-2048 causal training backward), B2
(`_bwd_fused_kernel`), B3 (`_dq_kernel`, `_dkdv_kernel`) and B4
(`_dbias_kernel`) compute one function; on the GPU it is three deterministic
kernels in `csrc/flash_bwd.cu`: dq, dk/dv and dbias. Tensors are BHSD views
with any strides (the head dim contiguous), as the forward takes them; the
gradients come back as BHSD views of BSHD-contiguous memory, so the public
API transposes them back without a copy.

delta = rowsum(o * do) - dlse * log2e is plain PyTorch here, as it is plain
jnp in the JAX package (`flash_bwd.py:2321-2329`): the fold of the
logsumexp cotangent, gated on finite lse and dlse so dead rows stay zero.

Dropout (`dropout_p > 0`, `flash_bwd.py:_recompute_p_and_ds` l.133-156):
the kernels regenerate the forward's keep mask from the same seed and
counter; p stays undropped, dp becomes keep ? dp / (1 - p) : 0 inside
ds = p (dp - delta), and dv's operand becomes keep ? p / (1 - p) : 0.

Causal routing (`flash_attn_backward` with `causal` and `static_skip`,
`backward_route`): the card's tuning table first (`bwd_route` entries per
GQA group, read as the forward's `fwd_route` ones are:
`flash_fwd.table_route`), else the prior, which is the JAX package's
dispatch (`flash_bwd.py:2189-2285`), with its gates copied verbatim and
evaluated at the shape the JAX API pads to (`flash_fwd.jax_padded_shape`)
and the real lengths:
the short tri-square range (B13, `csrc/flash_bwd_tri.cu`), the split
schedule when forced (B13 diag, the same kernel on diagonal leaves, then
B13 rect: `csrc/flash_bwd.cu` on each rectangle in its region mode, the
contributions added in fp32), the whole strip (B12) and the multi-strip
work list (B14, `csrc/flash_bwd_wl.cu` over the host table of
`build_causal_bwd_worklist`), else the fused / two-pass backward (B2, B3).
The strip, fused and two-pass routes launch the dq and dk/dv pair.

For bf16 / fp16 inputs the dq and dk/dv pair runs on tensor cores
(`csrc/flash_bwd.cu`'s `dq_mma_kernel`, and `dkdv_mma_kernel` on
`csrc/bwd_mma.cuh`'s tiles; one owner per output element, no partials),
and so does dbias (`dbias_mma_kernel`: persistent blocks, each dbias tile
summed over the bias's broadcast batch / head dims in a fixed order). So
do the tri-square, diag and work-list kernels (`csrc/bwd_mma.cuh`) over
host block partitions
(`tri_partition`, `wl_partition`: enough blocks of equal causal work to
fill the card, from the shape and its SM count), each block summing into
its own fp32 partials and a reduce kernel adding them in a fixed order;
fp32 inputs keep their FMA kernels.

CPU tensors take the plain twins (`flash_attn_backward_plain`, and for the
schedules the same function on leaves, rectangles or the work list's
steps, walking the same partitions) through the same routing; CUDA tensors
always launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from fa2_triton_tpu_torch.ops import _build
from fa2_triton_tpu_torch.ops.autotune import detect_chip
from fa2_triton_tpu_torch.ops.flash_fwd import (
    TILE_ROWS, _check_cuda_args, _killed, _masks, _reals, bias_view, causal_split_ok,
    causal_split_rects, dropout_c_args, dropout_mask, jax_padded_shape, reads_table,
    table_route, tri_square_ok)
from fa2_triton_tpu_torch.ops.tuning import BlockSizes
from fa2_triton_tpu_torch.utils import LOG2E

# Kernel launches since the last reset, per kernel (the smoke test reads
# these to show the training path went through the kernels).
LAUNCHES = {"flash_bwd_dq": 0, "flash_bwd_dkdv": 0, "flash_bwd_dbias": 0}
_KERNEL_IDS = {"flash_bwd_dq": 0, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 2}
# Launches of the causal backward schedules: csrc/flash_bwd_tri.cu without
# and with leaves (B13, B13 diag), one region backward of csrc/flash_bwd.cu
# (B13 rect: its dq and dk/dv kernels, counted here only) and
# csrc/flash_bwd_wl.cu (B14, with its dq reduction when there are strips).
SCHEDULE_LAUNCHES = dict.fromkeys(("tri_square", "causal_diag", "rect", "worklist"), 0)

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# The fused kernels' argtypes share a tail: the lens and strides pointers,
# then (q_off, kv_off, [causal, wl, wr,] scale, k_mul, 4 dropout args,
# Sq_real, Sk_real, the 16-bit kernels' partition table, its block count
# and the q and kv tile rows it was built for, stream).
_DROP_TAIL = [_I, _U, _U, _F, _I, _I, _P, _I, _I, _I, _P]
_ARGTYPES = {
    "fa2_flash_bwd": ([_I] * 8 + [_P] * 6 + [_P, _I, _I, _I] + [_P] * 4 + [_P, _P] + [_I] * 5
                      + [_F, _F] + [_I, _U, _U, _F, _I, _I, _I, _I, _P]),
    "fa2_flash_bwd_tri": [_I] * 8 + [_P] * 12 + [_P, _P] + [_I, _I, _F, _F] + _DROP_TAIL,
    "fa2_flash_bwd_wl": ([_I] * 7 + [_P] * 14 + [_P, _P, _I, _I, _I, _I] + [_P, _P]
                         + [_I] * 5 + [_F, _F] + _DROP_TAIL),
}
_c_fns = {}


def reset_launches() -> None:
    """Zero LAUNCHES and every SCHEDULE_LAUNCHES count."""
    for counts in (LAUNCHES, SCHEDULE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _entry(name: str = "fa2_flash_bwd"):
    if name not in _c_fns:
        fn = getattr(_build.load(), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _c_fns[name] = fn
    return _c_fns[name]


def compute_delta(o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                  dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """delta [B, Hq, Sq] fp32 = rowsum(o * do) - dlse * log2e (dlse only
    where both lse and dlse are finite)."""
    delta = (o.float() * do.float()).sum(-1)
    adj = _dlse_adjustment(lse, dlse)
    if adj is not None:
        delta = delta - adj
    return delta.contiguous()


def _dlse_adjustment(lse, dlse):
    """dlse * log2e where lse and dlse are finite, else 0 (JAX l.1006-1011);
    None without dlse."""
    if dlse is None:
        return None
    safe = torch.isfinite(lse) & torch.isfinite(dlse)
    return (torch.where(safe, dlse.float(), torch.zeros_like(lse)) * LOG2E).contiguous()


def _reduce_to_bias(ds_pre: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Sum [B, Hq, Sq, Sk] over the batch / head dims the bias broadcasts."""
    dims = [d for d in (0, 1) if bias.shape[d] == 1 and ds_pre.shape[d] > 1]
    return ds_pre.sum(dim=dims, keepdim=True) if dims else ds_pre


def flash_attn_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, lens: torch.Tensor,
    q_off: int = 0, kv_off: int = 0, bias: Optional[torch.Tensor] = None, *,
    causal: bool, softmax_scale: float, window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0, dlse: Optional[torch.Tensor] = None, compute_dbias: bool = False,
    dropout_p: float = 0.0, dropout_seed: int = 0,
    seqlen_q_real: Optional[int] = None, seqlen_k_real: Optional[int] = None,
):
    """The kernels' function in plain PyTorch, computed in fp32.

    Recomputes p = exp2(s * log2e - lse) from the base-2 LSE, then
    dp = do v^T, ds = p (dp - delta) (times the softcap's tanh' chain),
    dq = scale ds k, dk = scale ds^T q, dv = p^T do, with dk / dv summed
    over the GQA group and dbias = p (dp - delta) summed over the bias's
    broadcast batch / head dims. Rows past q_len and columns past kv_len
    are zeroed first, so padding that holds NaN cannot leak in. With
    dropout, dp and dv's p carry the forward's mask times 1 / (1 - p)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    q_len = lens[:, 0].to(device=dev, dtype=torch.int64)
    kv_len = lens[:, 1].to(device=dev, dtype=torch.int64)
    row_ok = ((q_off + torch.arange(Sq, device=dev))[None] < q_len[:, None]).view(B, 1, Sq, 1)
    col_ok = ((kv_off + torch.arange(Sk, device=dev))[None] < kv_len[:, None]).view(B, 1, Sk, 1)
    zero = torch.zeros((), device=dev)
    qf, dof = (torch.where(row_ok, x.float(), zero) for x in (q, do))
    kf, vf = (torch.where(col_ok, x.float(), zero).repeat_interleave(g, dim=1) for x in (k, v))
    delta = torch.where(row_ok[..., 0], compute_delta(o, do, lse, dlse), zero)

    s = torch.matmul(qf, kf.transpose(-1, -2)) * softmax_scale
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    if bias is not None:
        s = s + bias.float()
    finite = torch.isfinite(lse)
    keep = _masks(lens, q_off, kv_off, Sq, Sk, causal, window, dev) & finite[..., None]
    lse_safe = torch.where(finite, lse, zero)
    p = torch.where(keep, torch.exp2(s * LOG2E - lse_safe[..., None]), zero)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_dv = p
    if dropout_p > 0.0:
        keep_d = dropout_mask(B, Hq, Sq, Sk, q_off, kv_off, dropout_p, dropout_seed,
                              seqlen_q_real or Sq, seqlen_k_real or Sk, dev)
        drop = torch.where(keep_d, torch.tensor(1.0 / (1.0 - dropout_p), device=dev), zero)
        del keep_d
        dp = dp * drop
        p_dv = p * drop
    ds_pre = torch.where(keep, p * (dp - delta[..., None]), zero)
    ds = ds_pre * (1.0 - t * t) if softcap > 0.0 else ds_pre
    dq = torch.matmul(ds, kf) * softmax_scale
    dk = (torch.matmul(ds.transpose(-1, -2), qf) * softmax_scale).view(B, Hkv, g, Sk, D).sum(2)
    dv = torch.matmul(p_dv.transpose(-1, -2), dof).view(B, Hkv, g, Sk, D).sum(2)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if compute_dbias:
        return grads + (_reduce_to_bias(ds_pre, bias).to(bias.dtype),)
    return grads


def _kernel_layout(x: torch.Tensor, multiple: int = 4) -> torch.Tensor:
    """x itself if the kernels can read it (head dim contiguous, strides a
    multiple of `multiple` elements, 16-byte aligned base), else a BHSD view
    of a BSHD-contiguous copy (autograd may hand over e.g. an expanded do)."""
    if _aligned(x, multiple):
        return x
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def _mma_layout(x: torch.Tensor) -> torch.Tensor:
    """`_kernel_layout` at the strides the kernels of x's dtype read: 8
    elements (16-byte rows) for the 16-bit tensor-core kernels, 4 for fp32."""
    return _kernel_layout(x, 8 if x.element_size() == 2 else 4)


def _aligned(x: torch.Tensor, multiple: int) -> bool:
    return (x.stride(3) == 1 and not any(s % multiple for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_mma_rows(**tensors):
    """The 16-bit backward kernels copy rows of q, k, v and do 16 bytes at a
    time (cp.async): raise unless each has 16-byte aligned rows and base."""
    for name, t in tensors.items():
        if t.element_size() == 2 and not _aligned(t, 8):
            raise ValueError(f"the 16-bit backward kernels need {name} with a contiguous head "
                             f"dim, strides a multiple of 8 elements and a 16-byte aligned base; "
                             f"got strides {tuple(t.stride())}")


def _new_grads(q, k, zero=False):
    """(dq, dk, dv) as BHSD views of BSHD-contiguous memory, in the input
    dtypes (zero-filled when `zero`)."""
    alloc = torch.zeros if zero else torch.empty
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return (alloc((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2),
            alloc((B, Sk, Hkv, D), dtype=k.dtype, device=q.device).transpose(1, 2),
            alloc((B, Sk, Hkv, D), dtype=k.dtype, device=q.device).transpose(1, 2))


def _check_bwd_args(q, k, v, do, lens, lse, o=None):
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd takes CPU or CUDA tensors, got {q.device}")
    _check_cuda_args(q, k, v, lens)
    B, Hq, Sq, _ = q.shape
    for name, t in (("do", do), ("o", o)):
        if t is not None and (t.shape != q.shape or t.device != q.device):
            raise ValueError(f"{name} must be like q {tuple(q.shape)}, got {tuple(t.shape)} on {t.device}")
    if do.dtype != q.dtype:
        raise TypeError(f"do must have q's dtype {q.dtype}, got {do.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("lse must be an fp32 [B, Hq, Sq] tensor on q's device")


def _pair_backward(q, k, v, do, lse, delta, lens, q_off, kv_off, bias, *, causal, softmax_scale,
                   window, softcap, compute_dbias, dropout_p, dropout_seed, seqlen_q_real,
                   seqlen_k_real, k_prescaled=False):
    """Launch csrc/flash_bwd.cu's dq and dk/dv kernels (and dbias) on CUDA
    tensors, with delta given (do in `_mma_layout`). `k_prescaled` is the
    region mode: k comes multiplied by scale * log2e, and the launches are
    not counted in LAUNCHES (the caller counts them)."""
    _check_mma_rows(q=q, k=k, v=v, do=do)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = _new_grads(q, k)
    bv = bias_view(bias, q, Sk) if bias is not None else None
    dbias = None
    if compute_dbias:
        Bb, Hb = bias.shape[0], bias.shape[1]
        dbias = torch.empty((Bb, Hb, Sq, Sk), dtype=bias.dtype, device=q.device)
    else:
        Bb = Hb = 1
    if B == 0 or Hq == 0 or Sq == 0 or Sk == 0:
        for t in (dq, dk, dv) + ((dbias,) if dbias is not None else ()):
            t.zero_()
        return (dq, dk, dv) + ((dbias,) if dbias is not None else ())
    strides = (ctypes.c_longlong * 28)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        *(bv.stride() if bv is not None else (0, 0, 0, 0)),
        *(dbias.stride()[:3] if dbias is not None else (0, 0, 0)))
    args = (
        _build.DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Sk, D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        bv.data_ptr() if bv is not None else None,
        _build.DTYPE_CODES[bv.dtype] if bv is not None else 0, Bb, Hb,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr() if dbias is not None else None,
        lens.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        int(q_off), int(kv_off), int(bool(causal)), int(window[0]), int(window[1]),
        float(softmax_scale), float(softcap), *dropout_c_args(dropout_p, dropout_seed),
        int(seqlen_q_real or Sq), int(seqlen_k_real or Sk), int(k_prescaled), TILE_ROWS,
        _build.stream_ptr(q.device),
    )
    names = ("flash_bwd_dq", "flash_bwd_dkdv") + (("flash_bwd_dbias",) if dbias is not None else ())
    for name in names:
        _build.check(_entry()(_KERNEL_IDS[name], *args), f"{name} launch")
        if not k_prescaled:
            LAUNCHES[name] += 1
    return (dq, dk, dv) + ((dbias,) if dbias is not None else ())


def _generic_backward(q, k, v, do, o, lse, lens, q_off, kv_off, bias, *, dlse, **kw):
    """The dq / dk/dv (/ dbias) pair of csrc/flash_bwd.cu on CUDA tensors,
    its plain twin on CPU ones."""
    if q.device.type == "cpu":
        return flash_attn_backward_plain(q, k, v, do, o, lse, lens, q_off, kv_off, bias,
                                         dlse=dlse, **kw)
    _check_bwd_args(q, k, v, do, lens, lse, o)
    do = _mma_layout(do)
    return _pair_backward(q, k, v, do, lse.contiguous(), compute_delta(o, do, lse, dlse), lens,
                          q_off, kv_off, bias, **kw)


# ---------------------------------------------------------------------------
# Causal routing and its gates: `fa2_triton_tpu/ops/flash_bwd.py` l.827-843,
# 1240-1275 and 1957-1983 (and the tri-square gate inline at l.2196-2203),
# copied verbatim (pure Python), including the v5e-derived VMEM budgets and
# the strict `<` of the strip's, so that with no tuning table the same call
# takes the same schedule in both packages (the card's table:
# `flash_fwd.table_route`).


def bwd_causal_strip_ok(causal, static_skip, window, bias, varlen,
                        softcap, Sq, Sk, sq_real, sk_real, head_dim,
                        sub=512, vmem_budget=4096 * 128, dtype_bytes=2):
    """Eligibility for the whole-strip causal backward (JAX l.827): the TPU's
    K/V strips and whole-strip f32 dk/dv scratch must fit VMEM, strictly
    below Sk * head_dim == 4096 * 128, with the forward strip's alignment
    conditions."""
    shift = sk_real - sq_real
    return (causal and static_skip and window == (-1, -1) and bias is None
            and not varlen and softcap == 0.0 and dtype_bytes <= 2
            and Sq % sub == 0 and Sk % sub == 0 and Sq >= 2 * sub
            and shift >= 0 and shift % sub == 0 and Sq + shift <= Sk
            and Sk * head_dim < vmem_budget)


def tri_square_bwd_ok(causal, static_skip, window, softcap, Sq, Sk, sq_real, sk_real, head_dim,
                      group, dtype_bytes=2):
    """The tri-square backward's gate (JAX l.2196-2203): the forward's
    tri-square gate, and the whole query-head group's q block in the TPU's
    VMEM budget (group * Sq * head_dim * dtype_bytes <= 2048 * 128 * 2)."""
    return (softcap == 0.0
            and tri_square_ok(causal, static_skip, window, None, Sq, Sk, sq_real, sk_real,
                              head_dim=head_dim, dtype_bytes=dtype_bytes)
            and group * Sq * head_dim * dtype_bytes <= 2048 * 128 * 2)


def causal_split_bwd_ok(causal, static_skip, window, bias, varlen, softcap,
                        Sq, Sk, sq_real, sk_real, head_dim, group,
                        leaf_t=None, dtype_bytes=2):
    """Eligibility for the split-schedule backward (JAX l.1240): the
    forward split's gate at the backward leaf `bwd_split_leaf_t`; off by
    default (only an explicit leaf, or `causal_split=True`, reaches it)."""
    T = leaf_t if leaf_t is not None else bwd_split_leaf_t(head_dim, group, dtype_bytes)
    if T <= 0:
        return False
    base = causal_split_ok(causal, static_skip, window, bias, varlen,
                           softcap, Sq, Sk, sq_real, sk_real, head_dim,
                           leaf_t=T)
    if leaf_t is not None:
        return base
    return False


def bwd_split_leaf_t(head_dim: int, group: int, dtype_bytes: int = 2) -> int:
    """Largest bwd diagonal leaf fitting the TPU's tri-bwd VMEM budget
    (group * T * head_dim * dtype_bytes <= 2048 * 128 * 2, JAX l.1269), 0
    below the 1024-row floor."""
    t = 2048 * 128 * 2 // (group * head_dim * dtype_bytes)
    t = 1 << (t.bit_length() - 1) if t > 0 else 0  # floor to power of two
    return t if t >= 1024 else 0


def causal_wl_bwd_config(causal, static_skip, window, varlen, softcap,
                         Sq, Sk, sq_real, sk_real, head_dim, group,
                         dtype_bytes=2, sub=512):
    """(sub, block_kv) of the work-list whole-dq backward (JAX l.1957), or
    None: causal, MHA, static, multi-strip only (Sk past the TPU's single
    strip), with the TPU's ~8 MB dq + dk/dv scratch budget."""
    if not (causal and static_skip and softcap == 0.0 and not varlen
            and group == 1 and dtype_bytes <= 2):
        return None
    shift = sk_real - sq_real
    if Sq % sub or Sk % sub or shift < 0 or Sq + shift > Sk:
        return None
    bkv_max_single = 4 * 1024 * 1024 // (2 * 4 * head_dim)
    if Sk <= bkv_max_single:
        return None
    dq_bytes = Sq * head_dim * 4
    for bkv in (2048, 1024, 512):
        if Sk % bkv or bkv % sub:
            continue
        if dq_bytes + 2 * bkv * head_dim * 4 <= 8 * 1024 * 1024:
            return sub, bkv
    return None


# The work list's step flags and builder: JAX l.1776-1846, verbatim.
WL_INIT_DQ, WL_WRITE_DQ, WL_COMPUTE = 1, 2, 4
WL_MASK_GEN, WL_INIT_KV, WL_WRITE_KV, WL_MASK_TRI = 8, 16, 32, 64


def build_causal_bwd_worklist(
    nq: int, block_q: int, sub: int, nws: int, nsub_strip: int,
    group: int, shift: int, window=(-1, -1), causal=True,
    tri_ok=False, dq_whole=False,
) -> np.ndarray:
    """Static schedule: strip-major, then group member, then ascending rows,
    each row walking exactly its in-window/in-causal kv sub-tiles within the
    strip. Returns int32 [nsteps, 8]:
    (g, iq, ws_global, flags, strip, 0, 0, 0)."""
    right = 0 if causal else (window[1] if window[1] >= 0 else None)
    rows = []
    for iq in range(nq):
        lo = 0
        if window[0] >= 0:
            lo = max(0, (iq * block_q + shift - window[0]) // sub)
        hi = nws - 1
        if right is not None:
            hi = min(hi, max(0, (iq * block_q + block_q - 1 + shift + right)
                             // sub))
        rows.append((lo, hi))
    steps = []
    nkv = (nws + nsub_strip - 1) // nsub_strip
    row_seen = [[False] * nq for _ in range(group)]
    for strip in range(nkv):
        s_lo, s_hi = strip * nsub_strip, min(nws, (strip + 1) * nsub_strip) - 1
        strip_steps = []
        for g in range(group):
            for iq in range(nq):
                lo, hi = max(rows[iq][0], s_lo), min(rows[iq][1], s_hi)
                for ws in range(lo, hi + 1):
                    flags = WL_COMPUTE
                    col_lo, col_hi = ws * sub, (ws + 1) * sub - 1
                    below = (right is not None
                             and col_hi <= iq * block_q + shift
                             + (0 if causal else right))
                    if causal:
                        below = col_hi <= iq * block_q + shift
                    right_of_window = (
                        window[0] < 0
                        or col_lo >= iq * block_q + (block_q - 1)
                        + shift - window[0])
                    if not (below and right_of_window):
                        is_diag_tile = (causal and tri_ok and window[0] < 0
                                        and ws == rows[iq][1]
                                        and col_lo > iq * block_q + shift
                                        - sub)
                        flags |= WL_MASK_TRI if is_diag_tile else WL_MASK_GEN
                    if not dq_whole and not row_seen[g][iq]:
                        flags |= WL_INIT_DQ
                        row_seen[g][iq] = True
                    strip_steps.append([g, iq, ws, flags, strip, 0, 0, 0])
        if strip_steps:
            strip_steps[0][3] |= WL_INIT_KV
            strip_steps[-1][3] |= WL_WRITE_KV
            steps.extend(strip_steps)
    # dq writes: per-row mode writes at the row's LAST step overall;
    # whole-dq mode initializes everything at step 0 and writes at the end.
    if dq_whole:
        steps[0][3] |= WL_INIT_DQ
        steps[-1][3] |= WL_WRITE_DQ
    else:
        last_step = {}
        for i, st in enumerate(steps):
            if st[3] & WL_COMPUTE:
                last_step[(st[0], st[1])] = i
        for i in last_step.values():
            steps[i][3] |= WL_WRITE_DQ
    return np.asarray(steps, np.int32)


def backward_gates(Sq: int, Sk: int, head_dim: int, dtype_bytes: int, *, causal: bool,
                   group: int = 1, static_skip: bool = False,
                   window: Tuple[int, int] = (-1, -1), softcap: float = 0.0,
                   varlen: bool = False, seqlen_q_real: Optional[int] = None,
                   seqlen_k_real: Optional[int] = None, split_leaf: Optional[int] = None,
                   block_sizes: Optional[BlockSizes] = None,
                   chip: Optional[str] = None) -> dict:
    """{route: its prior gate passes}, in JAX's order (flash_bwd.py:
    2189-2285), at the shape the JAX API pads to (`jax_padded_shape`) and
    the real lengths (default Sq, Sk), for a call with no bias; "generic"
    (the dq + dk/dv pair) always passes. The split's gate is read at
    `split_leaf`, default `bwd_split_leaf_t` (JAX takes the split only with
    an explicit leaf; `backward_route` keeps that). Kill switches are not
    applied here."""
    Sq_p, Sk_p, Dp = jax_padded_shape(Sq, Sk, head_dim, dtype_bytes, block_sizes, chip)
    sq_real = seqlen_q_real if seqlen_q_real is not None else Sq
    sk_real = seqlen_k_real if seqlen_k_real is not None else Sk
    window = tuple(window)
    leaf = split_leaf if split_leaf is not None else bwd_split_leaf_t(Dp, group, dtype_bytes)
    return {
        "tri_square": tri_square_bwd_ok(causal, static_skip, window, softcap, Sq_p, Sk_p,
                                        sq_real, sk_real, Dp, group, dtype_bytes),
        "split": leaf > 0 and causal_split_bwd_ok(
            causal, static_skip, window, None, varlen, softcap, Sq_p, Sk_p, sq_real, sk_real,
            Dp, group, leaf_t=leaf, dtype_bytes=dtype_bytes),
        "strip": bwd_causal_strip_ok(causal, static_skip, window, None, varlen, softcap, Sq_p,
                                     Sk_p, sq_real, sk_real, head_dim=Dp,
                                     dtype_bytes=dtype_bytes),
        "worklist": causal_wl_bwd_config(causal, static_skip, window, varlen, softcap, Sq_p,
                                         Sk_p, sq_real, sk_real, Dp, group,
                                         dtype_bytes) is not None,
        "generic": True,
    }


def backward_route(Sq: int, Sk: int, head_dim: int, dtype_bytes: int, *, causal: bool,
                   group: int = 1, static_skip: bool = False,
                   window: Tuple[int, int] = (-1, -1), bias=None, softcap: float = 0.0,
                   varlen: bool = False, seqlen_q_real: Optional[int] = None,
                   seqlen_k_real: Optional[int] = None, fused: Optional[bool] = None,
                   causal_split: Optional[bool] = None,
                   split_leaf: Optional[int] = None, route: Optional[str] = None,
                   block_sizes: Optional[BlockSizes] = None,
                   chip: Optional[str] = None) -> str:
    """The schedule `flash_attn_backward` takes: "tri_square", "split",
    "strip", "worklist" or "generic" (the fused and two-pass routes);
    `head_dim` is the kernels' (64, 128 or 256), `dtype_bytes` the element
    size they compute in and `group` Hq / Hkv. With a bias, or
    `fused=False`, every schedule is skipped.

    `route` forces one by name (its gate must pass, and its kill switch be
    unset, else ValueError). Otherwise, where `flash_fwd.reads_table`
    holds, no split is forced and no kill switch (FA2_DISABLE_SPLIT /
    _STRIP / _WL) is set, `chip`'s `bwd_route` entry (variant
    `g<group>`) at (head_dim, max(Sq, Sk)) decides when its prior gate
    passes (`table_route`). Else the prior, JAX's dispatch: the kill
    switches are read at call time, and a split forced on
    (`causal_split=True`) whose gate fails raises ValueError; forced off
    it is skipped."""
    if bias is not None or fused is False:
        if route not in (None, "generic"):
            raise ValueError(f"{route} forced on a call with a bias or fused=False")
        return "generic"
    ok = backward_gates(Sq, Sk, head_dim, dtype_bytes, causal=causal, group=group,
                        static_skip=static_skip, window=window, softcap=softcap, varlen=varlen,
                        seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real,
                        split_leaf=split_leaf, block_sizes=block_sizes, chip=chip)
    if route is not None:
        if route not in ok:
            raise ValueError(f"unknown backward route {route!r}; one of {tuple(ok)}")
        if not ok[route] or _killed(route):
            raise ValueError(f"{route} forced but its preconditions are not met (Sq {Sq}, Sk "
                             f"{Sk}, head_dim {head_dim}, group {group})")
        return route
    if (reads_table(causal, static_skip, window, None, softcap, varlen, dtype_bytes)
            and causal_split is None and split_leaf is None):
        taken = table_route("bwd_route", ok, head_dim, max(Sq, Sk), chip, variant=f"g{group}")
        if taken is not None:
            return taken
    if ok["tri_square"]:
        return "tri_square"
    ok_split = split_leaf is not None and ok["split"] and not _killed("split")
    if causal_split if causal_split is not None else ok_split:
        if not ok_split:
            raise ValueError(f"causal_split forced but its preconditions are not met (Sq {Sq}, "
                             f"Sk {Sk}, head_dim {head_dim}, group {group}, split_leaf "
                             f"{split_leaf})")
        return "split"
    for name in ("strip", "worklist"):
        if ok[name] and not _killed(name):
            return name
    return "generic"


# ---------------------------------------------------------------------------
# Block partitions of the 16-bit fused kernels (csrc/bwd_mma.cuh): built on
# the host from shapes only, cached, and handed to the kernels as device
# int32 tables. The plain twins walk the same partitions. The number of
# blocks follows the shape and the card's SM count; CPU tensors take the
# H100's, so a twin walks what the card's kernel walks.

H100_SMS = 132          # streaming multiprocessors of the H100 SXM
FUSED_BQ = 64           # q rows of a streamed tile (bwd_mma.cuh MmaCfg::BQ; the
                        # kernels refuse a partition built for other tiles)
BALANCE = 1.25          # the largest block's work over the mean, at most


def fused_kv_tile(head_dim: int) -> int:
    """kv rows of a 16-bit fused block's tile (bwd_mma.cuh MmaCfg::BKV)."""
    return 128 if head_dim <= 128 else 64


def sm_count(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def _q_tiles(r_lo: int, r_hi: int) -> int:
    """FUSED_BQ-row q tiles the kernels walk for rows [r_lo, r_hi)."""
    if r_hi <= r_lo:
        return 0
    return -(-(r_hi - r_lo // FUSED_BQ * FUSED_BQ) // FUSED_BQ)


def _tile_rows(k0, c_lim, shift, q_valid, causal=True, window=(-1, -1)):
    """The q rows [r_lo, r_hi) that kv columns [k0, c_lim) meet
    (bwd_fused.cuh:kv_tile_rows at offset 0)."""
    r_lo, r_hi = 0, q_valid
    if causal:
        r_lo = max(0, k0 - shift)
    elif window[1] >= 0:
        r_lo = max(0, k0 - shift - window[1])
    if window[0] >= 0:
        r_hi = min(r_hi, c_lim - 1 - shift + window[0] + 1)
    return (r_lo, r_hi) if c_lim > k0 else (r_lo, 0)


def _ratio(loads) -> float:
    """Largest over mean block work (1 for no work)."""
    total = sum(loads)
    return max(loads) * len(loads) / total if total else 1.0


def _makespan(loads, copies, sms):
    """Work of the busiest SM when the blocks (`loads`, launched `copies`
    times in order) go to `sms` SMs as each frees up, one block at a time:
    the 16-bit fused kernels fit one block per SM."""
    free = [0] * sms
    for _ in range(copies):
        for ld in loads:
            heapq.heapreplace(free, free[0] + ld)
    return max(free)


def _pick(candidates, copies, sms):
    """The candidate (loads, payload) that finishes first on `sms` SMs, among
    those within BALANCE when any is; ties go to one that fills the card,
    then to fewer blocks (less fp32 partial memory)."""
    ok = [c for c in candidates if _ratio(c[0]) <= BALANCE] or candidates
    return min(ok, key=lambda c: (_makespan(c[0], copies, sms), len(c[0]) * copies < sms,
                                  len(c[0])))


def _lpt(weights, bins):
    """Largest weight first into the least loaded bin (ties: the lowest
    index): the item indices of each bin and its load."""
    lists, loads = [[] for _ in range(bins)], [0] * bins
    for i in sorted(range(len(weights)), key=lambda i: (-weights[i], i)):
        j = min(range(bins), key=lambda b: (loads[b], b))
        lists[j].append(i)
        loads[j] += weights[i]
    return lists, loads


@functools.lru_cache(maxsize=64)
def tri_partition(Sq, Sk, shift, leaf, group, B, Hkv, head_dim, sms):
    """B13's blocks: for each leaf (one span when `leaf` is 0), P blocks per
    (kv head, batch row), each a list of kv tile starts (tiles of
    `fused_kv_tile` rows) in ascending order. Tile t goes with tile n - 1 - t
    (together one full row of causal work) and the pairs are dealt largest
    first to the least loaded block. Work is counted in (q tile, kv tile)
    pairs over the GQA group at the static shift; P is `_pick`'s choice.
    Returns (P, starts int32 [leaves * P + 1], tiles int32, work per
    block)."""
    bkv = fused_kv_tile(head_dim)
    spans = ([(0, Sq, Sk)] if leaf == 0 else
             [(l0, min(l0 + leaf, Sq), min(l0 + leaf, Sk)) for l0 in range(0, Sq, leaf)])
    leaves = []
    for R0, R1, C1 in spans:
        tiles = list(range(R0, C1, bkv))
        work = []
        for k0 in tiles:
            r_lo, r_hi = _tile_rows(k0, min(k0 + bkv, C1), shift, Sq)
            work.append(group * _q_tiles(max(r_lo, R0), min(r_hi, R1)))
        n = len(tiles)
        items = [sorted({t, n - 1 - t}) for t in range((n + 1) // 2)]
        leaves.append((tiles, items, [sum(work[i] for i in it) for it in items]))
    candidates = []
    for P in range(1, max(len(x[1]) for x in leaves) + 1):
        blocks = []
        for tiles, items, weights in leaves:
            lists, loads = _lpt(weights, P)
            blocks += [(sorted(tiles[t] for it in l for t in items[it]), ld)
                       for l, ld in zip(lists, loads)]
        candidates.append(([ld for _, ld in blocks], (P, blocks)))
    P, blocks = _pick(candidates, B * Hkv, sms)[1]
    starts = np.cumsum([0] + [len(t) for t, _ in blocks]).astype(np.int32)
    tiles = np.asarray([k0 for t, _ in blocks for k0 in t], np.int32)
    return P, starts, tiles, tuple(ld for _, ld in blocks)


def _cuts(weights, k):
    """k contiguous runs of `weights`: boundaries 0 < b_1 < ... < n, b_j the
    row boundary whose prefix sum is nearest j / k of the total."""
    pre = np.cumsum(weights)
    n, total = len(weights), pre[-1]
    cuts = [0]
    for j in range(1, k):
        target = j * total / k
        cuts.append(min(range(cuts[-1] + 1, n - (k - j) + 1),
                        key=lambda b: (abs(pre[b - 1] - target), b)))
    return cuts + [n]


@functools.lru_cache(maxsize=64)
def wl_partition(schedule, Sq, Sk, B, Hkv, head_dim, sms):
    """B14's chunks: each strip's steps cut at row boundaries (a row: the
    run of steps of one (g, iq)) into chunks of about equal work, K chunks
    in all spread over the strips by their work, one block per (chunk, kv
    head, batch row). Work is counted in (q tile, kv tile) pairs at the
    static shift; K is `_pick`'s choice. Returns (chunk step starts int32 [C + 1], first chunk of each
    strip int32 [strips + 1], cover int32 [strips, nq]: 1 where the strip's
    steps hold q-row block iq, work per chunk)."""
    table, _ = _worklist(*schedule)
    nq, sub, nws, nsub_strip, _, shift, window, causal = schedule[:8]
    bkv = fused_kv_tile(head_dim)
    strips = -(-nws // nsub_strip)
    rows = {}  # strip -> [[first step, end step, work, (g, iq)], ...]
    for i, (g, iq, ws, _, strip, *_) in enumerate(table.tolist()):
        w_end = min((ws + 1) * sub, Sk)
        work = 0
        for k0 in range(ws * sub, w_end, bkv):
            r_lo, r_hi = _tile_rows(k0, min(k0 + bkv, w_end), shift, Sq, causal, window)
            work += _q_tiles(max(iq * sub, r_lo), min((iq + 1) * sub, Sq, r_hi))
        runs = rows.setdefault(strip, [])
        if runs and runs[-1][3] == (g, iq):
            runs[-1][1] = i + 1
            runs[-1][2] += work
        else:
            runs.append([i, i + 1, work, (g, iq)])
    total = sum(r[2] for runs in rows.values() for r in runs)
    candidates = []
    for K in range(1, sum(len(r) for r in rows.values()) + 1):
        chunks = []
        for strip in sorted(rows):
            runs = rows[strip]
            k = min(len(runs), max(1, int(sum(r[2] for r in runs) * K / max(total, 1) + 0.5)))
            cuts = _cuts([r[2] for r in runs], k)
            chunks += [(strip, runs[a][0], runs[b - 1][1], sum(r[2] for r in runs[a:b]))
                       for a, b in zip(cuts[:-1], cuts[1:])]
        if not candidates or len(chunks) != len(candidates[-1][0]):
            candidates.append(([c[3] for c in chunks], chunks))
    chunks = _pick(candidates, B * Hkv, sms)[1]
    starts = np.asarray([c[1] for c in chunks] + [chunks[-1][2]], np.int32)
    firsts = np.searchsorted([c[0] for c in chunks], np.arange(strips + 1)).astype(np.int32)
    cover = np.zeros((strips, nq), np.int32)
    for g, iq, ws, _, strip, *_ in table.tolist():
        cover[strip, iq] = 1
    return starts, firsts, cover, tuple(c[3] for c in chunks)


_DEVICE_TABLES = {}


def _device_int32(key, arrays, device):
    """The int32 arrays concatenated into one device tensor, copied once per
    key and device."""
    if (key, device) not in _DEVICE_TABLES:
        _DEVICE_TABLES[(key, device)] = torch.from_numpy(
            np.concatenate([np.asarray(a, np.int32).ravel() for a in arrays])).to(device)
    return _DEVICE_TABLES[(key, device)]


# ---------------------------------------------------------------------------
# The schedules and their plain twins.


def _fused_region_plain(q, k_p, v, do, lse, delta, lens, q_off, kv_off, *, rows, cols, causal,
                        window=(-1, -1), masked=True, g=None, dropout_p=0.0, dropout_seed=0,
                        seqlen_q_real, seqlen_k_real):
    """The fused kernels' sums over q rows `rows` x kv columns `cols`
    (slices) in fp32, with k prescaled (k_p = k * scale * log2e), the global
    lse and delta: (ds k_p [B, H, nr, D], ds^T q and p^T do [B, Hkv, nc, D]).
    `masked` applies the causal / window mask; without it only the lengths
    (a work-list step the table marks unmasked). `g` None takes every q
    head (dk / dv summed over the group), an int only the heads
    hk * group + g."""
    B, Hq, _, D = q.shape
    Hkv = k_p.shape[1]
    group = Hq // Hkv
    heads = slice(None) if g is None else slice(g, None, group)
    rep = group if g is None else 1
    dev = q.device
    r0, c0 = rows.start, cols.start
    qr, dor, lse_r, delta_r = q[:, heads, rows], do[:, heads, rows], lse[:, heads, rows], delta[:, heads, rows]
    kc, vc = k_p[:, :, cols], v[:, :, cols]
    nr, nc = qr.shape[2], kc.shape[2]
    q_len = lens[:, 0].to(device=dev, dtype=torch.int64)
    kv_len = lens[:, 1].to(device=dev, dtype=torch.int64)
    row_ok = ((q_off + r0 + torch.arange(nr, device=dev))[None] < q_len[:, None]).view(B, 1, nr, 1)
    col_ok = ((kv_off + c0 + torch.arange(nc, device=dev))[None] < kv_len[:, None]).view(B, 1, nc, 1)
    zero = torch.zeros((), device=dev)
    qf, dof = (torch.where(row_ok, x.float(), zero) for x in (qr, dor))
    kf, vf = (torch.where(col_ok, x.float(), zero).repeat_interleave(rep, dim=1) for x in (kc, vc))
    keep = _masks(lens, q_off + r0, kv_off + c0, nr, nc, causal if masked else False,
                  tuple(window) if masked else (-1, -1), dev)
    finite = torch.isfinite(lse_r)
    keep = keep & finite[..., None]
    s2 = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.where(keep, torch.exp2(s2 - torch.where(finite, lse_r, zero)[..., None]), zero)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_dv = p
    if dropout_p > 0.0:
        keep_d = dropout_mask(B, Hq, nr, nc, q_off + r0, kv_off + c0, dropout_p, dropout_seed,
                              seqlen_q_real, seqlen_k_real, dev)[:, heads]
        drop = torch.where(keep_d, torch.tensor(1.0 / (1.0 - dropout_p), device=dev), zero)
        dp = dp * drop
        p_dv = p * drop
    ds = torch.where(keep, p * (dp - torch.where(row_ok[..., 0], delta_r, zero)[..., None]), zero)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf).view(B, Hkv, rep, nc, D).sum(2)
    dv = torch.matmul(p_dv.transpose(-1, -2), dof).view(B, Hkv, rep, nc, D).sum(2)
    return dq, dk, dv


def _fused_strides(q, k, v, do, o, dq, dk, dv):
    return (ctypes.c_longlong * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *(o.stride()[:3] if o is not None else (0, 0, 0)),
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3])


def _prescale_k(k, softmax_scale):
    """k * scale * log2e rounded to k's dtype (JAX l.1303-1304)."""
    return (k.float() * (softmax_scale * LOG2E)).to(k.dtype)


def _tri_launch(kernel, q, k, v, do, o, lse, delta, lens, q_off, kv_off, *, leaf, softmax_scale,
                dropout_p, dropout_seed, seqlen_q_real, seqlen_k_real):
    """Launch csrc/flash_bwd_tri.cu: "tri_square" (o given: k folded and
    delta = rowsum(o * do) - delta in the kernels, delta the dlse adjustment
    or None) or "causal_diag" (leaf T, k prescaled, delta given). 16-bit
    inputs take the tensor-core kernel on `tri_partition`'s blocks (a delta
    prologue, the main kernel, the dq reduction), fp32 ones the FMA kernel.
    Returns (dq, dk, dv) in the input dtypes."""
    _check_bwd_args(q, k, v, do, lens, lse, o)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    mma = q.element_size() == 2
    do = _mma_layout(do)
    o = _mma_layout(o) if o is not None else None
    if mma:
        _check_mma_rows(q=q, k=k, v=v)
    dq, dk, dv = _new_grads(q, k)
    if B == 0 or Hq == 0 or Sq == 0 or Sk == 0:
        return tuple(t.zero_() for t in (dq, dk, dv))
    lse = lse.contiguous()
    part, nparts = None, 0
    if mma:
        key = (Sq, Sk, sk_real - sq_real, int(leaf), Hq // Hkv, B, Hkv, D, sm_count(q.device))
        nparts, starts, tiles, _ = tri_partition(*key)
        part = _device_int32(("tri", key), (starts, tiles), q.device)
    dq_acc = torch.empty(((nparts,) if mma else ()) + (B, Hq, Sq, D), dtype=torch.float32,
                         device=q.device)
    delta_buf = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if o is not None else None
    strides = _fused_strides(q, k, v, do, o, dq, dk, dv)
    ptr = lambda t: t.data_ptr() if t is not None else None
    status = _entry("fa2_flash_bwd_tri")(
        _build.DTYPE_CODES[q.dtype], int(leaf), B, Hq, Hkv, Sq, Sk, D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), ptr(o), lse.data_ptr(),
        ptr(delta), ptr(delta_buf), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lens.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), int(q_off), int(kv_off),
        float(softmax_scale), float(softmax_scale * LOG2E) if o is not None else 0.0,
        *dropout_c_args(dropout_p, dropout_seed), int(sq_real), int(sk_real), ptr(part),
        int(nparts), FUSED_BQ, fused_kv_tile(D), _build.stream_ptr(q.device))
    _build.check(status, f"flash_bwd {kernel} launch")
    SCHEDULE_LAUNCHES[kernel] += 1
    return dq, dk, dv


def _tri_plain(q, k_p, v, do, lse, delta, lens, q_off=0, kv_off=0, *, leaf, softmax_scale,
               dropout_p=0.0, dropout_seed=0, seqlen_q_real=None, seqlen_k_real=None):
    """The tri kernel's plain twin, in fp32: `tri_partition`'s blocks in
    order, each adding its tiles' fused sums (causal, over its leaf's rows)
    into its own dq partial and writing their dk / dv, then the partials
    added in block order. k_p is k * scale * log2e (any dtype)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k_p.shape[1], k_p.shape[2]
    sq_real, sk_real = _reals(q, k_p, seqlen_q_real, seqlen_k_real)
    P, starts, tiles, _ = tri_partition(Sq, Sk, sk_real - sq_real, int(leaf), Hq // Hkv, B, Hkv, D,
                                        sm_count(q.device))
    bkv = fused_kv_tile(D)
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = torch.zeros((P, B, Hq, Sq, D), **f32)
    dk, dv = torch.zeros((B, Hkv, Sk, D), **f32), torch.zeros((B, Hkv, Sk, D), **f32)
    for x in range(len(starts) - 1):
        l0 = (x // P) * leaf
        rows = slice(l0, min(l0 + leaf, Sq) if leaf else Sq)
        c1 = min(l0 + leaf, Sk) if leaf else Sk
        for k0 in tiles[starts[x]:starts[x + 1]].tolist():
            cols = slice(k0, min(k0 + bkv, c1))
            dqr, dkr, dvr = _fused_region_plain(
                q, k_p, v, do, lse, delta, lens, q_off, kv_off, rows=rows, cols=cols, causal=True,
                dropout_p=dropout_p, dropout_seed=dropout_seed, seqlen_q_real=sq_real,
                seqlen_k_real=sk_real)
            parts[x % P][:, :, rows] += dqr
            dk[:, :, cols] = dkr
            dv[:, :, cols] = dvr
    dq = parts[0]
    for j in range(1, P):
        dq = dq + parts[j]
    return (dq / LOG2E).to(q.dtype), (dk * softmax_scale).to(v.dtype), dv.to(v.dtype)


def flash_attn_backward_tri_square(q, k, v, do, o, lse, lens, q_off=0, kv_off=0, *,
                                   softmax_scale, dropout_p=0.0, dropout_seed=0,
                                   seqlen_q_real=None, seqlen_k_real=None, dlse=None):
    """B13, the short causal fused backward (JAX l.985; csrc/flash_bwd_tri.cu),
    the k fold and delta in the kernels and only the dlse adjustment on the
    host (l.1006-1011): 16-bit inputs on `tri_partition`'s blocks (enough
    per (batch row, kv head) to fill the card), fp32 ones one block per
    (batch row, kv head) over the whole sequence and GQA group. JAX's
    precondition (l.1001) with the row tile TILE_ROWS in place of the TPU's
    sub-tile: a shift sk_real - sq_real that is a multiple of it (the port
    does not pad, so the lengths are free). CPU tensors take `_tri_plain`
    on k * scale * log2e in fp32 (the function of
    `flash_attn_backward_plain`, summed as the partition sums it)."""
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    if (sk_real - sq_real) % TILE_ROWS:
        raise ValueError(f"tri_square needs a shift that is a multiple of {TILE_ROWS}, got "
                         f"{sk_real - sq_real}")
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=sq_real, seqlen_k_real=sk_real)
    if q.device.type == "cpu":
        return _tri_plain(q, k.float() * (softmax_scale * LOG2E), v, do, lse,
                          compute_delta(o, do, lse, dlse), lens, q_off, kv_off, leaf=0, **kw)
    return _tri_launch("tri_square", q, k, v, do, o, lse, _dlse_adjustment(lse, dlse), lens,
                       q_off, kv_off, leaf=0, **kw)


def flash_attn_backward_causal_diag(q, k_p, v, do, lse, delta, lens, q_off=0, kv_off=0, *, T,
                                    softmax_scale, dropout_p=0.0, dropout_seed=0,
                                    seqlen_q_real=None, seqlen_k_real=None):
    """B13 diag (JAX l.1060): the backward of every diagonal T x T causal
    leaf in one launch (csrc/flash_bwd_tri.cu: 16-bit inputs on
    `tri_partition`'s blocks per leaf, fp32 one block per leaf, batch row
    and kv head), from the prescaled k_p (k * scale * log2e in k's dtype) and
    the global delta. Full-size outputs in the input dtypes; local row r
    meets only the columns of its own leaf. Needs Sq == Sk and T a multiple
    of the 64-row tile; the port does not pad, so the last leaf may be
    short."""
    Sq = q.shape[2]
    if not (Sq == k_p.shape[2] and T > 0 and T % TILE_ROWS == 0):
        raise ValueError(f"causal_diag needs Sq == Sk and T a multiple of {TILE_ROWS}; got Sq "
                         f"{Sq}, Sk {k_p.shape[2]}, T {T}")
    sq_real, sk_real = _reals(q, k_p, seqlen_q_real, seqlen_k_real)
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=sq_real, seqlen_k_real=sk_real)
    if q.device.type == "cpu":
        return flash_attn_backward_causal_diag_plain(q, k_p, v, do, lse, delta, lens, q_off,
                                                     kv_off, T=T, **kw)
    return _tri_launch("causal_diag", q, k_p, v, do, None, lse, delta.contiguous(), lens, q_off,
                       kv_off, leaf=T, **kw)


def flash_attn_backward_causal_diag_plain(q, k_p, v, do, lse, delta, lens, q_off=0, kv_off=0, *,
                                          T, softmax_scale, dropout_p=0.0, dropout_seed=0,
                                          seqlen_q_real=None, seqlen_k_real=None):
    """The diag kernel's plain twin: `_tri_plain` on the T x T leaves."""
    return _tri_plain(q, k_p, v, do, lse, delta, lens, q_off, kv_off, leaf=T,
                      softmax_scale=softmax_scale, dropout_p=dropout_p,
                      dropout_seed=dropout_seed, seqlen_q_real=seqlen_q_real,
                      seqlen_k_real=seqlen_k_real)


def _region(q, k, row0, col0, nrows, ncols):
    Sq, Sk = q.shape[2], k.shape[2]
    if not (0 <= row0 < Sq and 0 <= col0 < Sk and nrows > 0 and ncols > 0):
        raise ValueError(f"rect rows [{row0}, +{nrows}) / columns [{col0}, +{ncols}) do not meet "
                         f"the tensors' {Sq} rows and {Sk} columns")
    return slice(row0, min(row0 + nrows, Sq)), slice(col0, min(col0 + ncols, Sk))


def flash_attn_backward_rect(q, k_p, v, do, lse, delta, lens, q_off=0, kv_off=0, *, row0, col0,
                             nrows, ncols, softmax_scale, dropout_p=0.0, dropout_seed=0,
                             seqlen_q_real=None, seqlen_k_real=None):
    """B13 rect (JAX l.1138): the non-causal backward of q rows [row0,
    row0 + nrows) against kv columns [col0, col0 + ncols) of the full
    tensors, cut to their lengths, from the prescaled k_p and the global lse
    and delta, so the region's share of the global gradient comes out
    exactly. Returns region-sized (dq, dk, dv) in the input dtypes. On the
    GPU, csrc/flash_bwd.cu's dq and dk/dv kernels in their region mode (views
    of the region, offsets moved by its origin so masks and dropout stay
    global): they already compute this function, and a region is one flag
    away; one call counts one `rect` launch and none of LAUNCHES."""
    rows, cols = _region(q, k_p, row0, col0, nrows, ncols)
    sq_real, sk_real = _reals(q, k_p, seqlen_q_real, seqlen_k_real)
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=sq_real, seqlen_k_real=sk_real)
    if q.device.type == "cpu":
        return flash_attn_backward_rect_plain(q, k_p, v, do, lse, delta, lens, q_off, kv_off,
                                              row0=row0, col0=col0, nrows=nrows, ncols=ncols, **kw)
    _check_bwd_args(q, k_p, v, do, lens, lse)
    do = _mma_layout(do)
    grads = _pair_backward(
        q[:, :, rows], k_p[:, :, cols], v[:, :, cols], do[:, :, rows],
        lse[:, :, rows].contiguous(), delta[:, :, rows].contiguous(), lens, q_off + rows.start,
        kv_off + cols.start, None, causal=False, window=(-1, -1), softcap=0.0,
        compute_dbias=False, k_prescaled=True, **kw)
    SCHEDULE_LAUNCHES["rect"] += 1
    return grads


def flash_attn_backward_rect_plain(q, k_p, v, do, lse, delta, lens, q_off=0, kv_off=0, *, row0,
                                   col0, nrows, ncols, softmax_scale, dropout_p=0.0,
                                   dropout_seed=0, seqlen_q_real=None, seqlen_k_real=None):
    """The rect's plain twin: the fused sums, not causal, on the region."""
    rows, cols = _region(q, k_p, row0, col0, nrows, ncols)
    sq_real, sk_real = _reals(q, k_p, seqlen_q_real, seqlen_k_real)
    dq, dk, dv = _fused_region_plain(q, k_p, v, do, lse, delta, lens, q_off, kv_off, rows=rows,
                                     cols=cols, causal=False, dropout_p=dropout_p,
                                     dropout_seed=dropout_seed, seqlen_q_real=sq_real,
                                     seqlen_k_real=sk_real)
    return ((dq / LOG2E).to(q.dtype), (dk * softmax_scale).to(k_p.dtype), dv.to(v.dtype))


def _causal_split_backward(q, k, v, do, o, lse, lens, q_off=0, kv_off=0, *, softmax_scale,
                           dropout_p=0.0, dropout_seed=0, seqlen_q_real=None, seqlen_k_real=None,
                           dlse=None, leaf_t=None, block_sizes=None, chip=None):
    """The split causal backward (JAX l.1278): the prescaled k and the
    global delta once, one diag launch over the T x T leaves, then one rect
    per `causal_split_rects(n)` entry, added in: gradients are additive over
    the regions, each recomputing p from the global lse. The diag's outputs
    are stored in the input dtypes and upcast, the sums run in fp32 and are
    cast once at the end (l.1320-1354). T defaults to `bwd_split_leaf_t` at
    the padded head dim; n counts the leaves of the length JAX pads to, and
    a rectangle whose rows lie past the tensors' (JAX's padding) is left
    out."""
    Sq, D, nbytes = q.shape[2], q.shape[3], q.element_size()
    group = q.shape[1] // k.shape[1]
    Sq_p, _, Dp = jax_padded_shape(Sq, k.shape[2], D, nbytes, block_sizes, chip)
    T = leaf_t if leaf_t is not None else bwd_split_leaf_t(Dp, group, nbytes)
    n = -(-Sq_p // T)
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    k_p = _prescale_k(k, softmax_scale)
    delta = compute_delta(o, do, lse, dlse)
    dq, dk, dv = (x.float() for x in flash_attn_backward_causal_diag(
        q, k_p, v, do, lse, delta, lens, q_off, kv_off, T=T, **kw))
    for r0, c0, nr, nc in causal_split_rects(n):
        if r0 * T >= Sq:
            continue
        rows, cols = _region(q, k, r0 * T, c0 * T, nr * T, nc * T)
        dqr, dkr, dvr = flash_attn_backward_rect(q, k_p, v, do, lse, delta, lens, q_off, kv_off,
                                                 row0=r0 * T, col0=c0 * T, nrows=nr * T,
                                                 ncols=nc * T, **kw)
        dq[:, :, rows] += dqr.float()
        dk[:, :, cols] += dkr.float()
        dv[:, :, cols] += dvr.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _wl_geometry(Sq, Sk, group, shift, sub, block_kv):
    """(nq, nws, nsub_strip, tri_ok, dq_whole) of the work list over the
    port's tensors (JAX l.2017-2056, lengths rounded up to `sub`)."""
    nq, nws = -(-Sq // sub), -(-Sk // sub)
    block_kv = block_kv if block_kv is not None else nws * sub
    if sub % TILE_ROWS or block_kv % sub:
        raise ValueError(f"the work list needs sub a multiple of {TILE_ROWS} and block_kv of sub; "
                         f"got sub {sub}, block_kv {block_kv}")
    nsub_strip = block_kv // sub
    dq_whole = -(-nws // nsub_strip) > 1
    if dq_whole and group != 1:
        raise ValueError("the multi-strip work-list backward needs MHA (its whole-sequence dq "
                         f"accumulator is per head); got a group of {group}")
    tri_ok = shift % sub == 0 and shift >= 0 and nq * sub + shift <= nws * sub
    return nq, nws, nsub_strip, tri_ok, dq_whole


@functools.lru_cache(maxsize=64)
def _worklist(nq, sub, nws, nsub_strip, group, shift, window, causal, tri_ok, dq_whole):
    """(table int32 [nsteps, 8], starts int32 [strips + 1]: each strip's
    first step, then nsteps)."""
    table = build_causal_bwd_worklist(nq, sub, sub, nws, nsub_strip, group, shift, window=window,
                                      causal=causal, tri_ok=tri_ok, dq_whole=dq_whole)
    strip = table[:, 4]
    starts = np.flatnonzero(np.r_[True, strip[1:] != strip[:-1]])
    return table, np.r_[starts, len(table)].astype(np.int32)


def _device_worklist(key, device):
    """The table and its strip starts as one device int32 tensor."""
    return _device_int32(("worklist", key), _worklist(*key), device)


def flash_attn_backward_fused_wl(q, k, v, do, o, lse, lens, q_off=0, kv_off=0, *,
                                 causal=True, softmax_scale, window=(-1, -1), dropout_p=0.0,
                                 dropout_seed=0, sub=512, block_kv=None, seqlen_q_real=None,
                                 seqlen_k_real=None, dlse=None):
    """B14, the work-list fused backward (JAX l.1986): one call over the
    host schedule `build_causal_bwd_worklist` (block_q == sub; strips of
    `block_kv` columns, None = one strip), as csrc/flash_bwd_wl.cu. With one
    strip the k fold and delta are in the kernel and each row's dq is
    initialised and written at its table flags; with several (dq_whole, MHA
    only) k is prescaled and delta computed on the host (l.2033-2048), each
    strip sums into its own fp32 dq partial and a reduction writes dq.
    16-bit inputs take the tensor-core kernel on `wl_partition`'s chunks
    (each strip's steps cut at row boundaries; fp32 dk / dv partials per
    chunk, added by the reduction), fp32 ones the FMA kernel with one block
    per strip. The table covers the port's tensors (their lengths rounded up
    to `sub`). CPU tensors take `flash_attn_backward_fused_wl_plain`, which
    walks the same table and chunks. Softcap is not taken (the routing
    never passes it)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    window = tuple(int(w) for w in window)
    nq, nws, nsub_strip, tri_ok, dq_whole = _wl_geometry(Sq, Sk, group, sk_real - sq_real, sub,
                                                         block_kv)
    key = (nq, sub, nws, nsub_strip, group, sk_real - sq_real, window, bool(causal), tri_ok,
           dq_whole)
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=sq_real, seqlen_k_real=sk_real)
    if q.device.type == "cpu":
        return flash_attn_backward_fused_wl_plain(q, k, v, do, o, lse, lens, q_off, kv_off,
                                                  schedule=key, causal=causal, window=window,
                                                  dlse=dlse, **kw)
    _check_bwd_args(q, k, v, do, lens, lse, o)
    mma = q.element_size() == 2
    do = _mma_layout(do)
    dq, dk, dv = _new_grads(q, k, zero=True)
    if B == 0 or Hq == 0 or Sq == 0 or Sk == 0:
        return dq, dk, dv
    if dq_whole:
        k_in, o_in, delta, k_mul = _prescale_k(k, softmax_scale), None, compute_delta(o, do, lse, dlse), 0.0
    else:
        k_in, o_in = k, _kernel_layout(o)
        delta, k_mul = _dlse_adjustment(lse, dlse), softmax_scale * LOG2E
    strip_cols = nsub_strip * sub
    f32 = dict(dtype=torch.float32, device=q.device)
    tbl = _device_worklist(key, q.device)
    nsteps = len(_worklist(*key)[0])
    parts = tbl.numel() - 8 * nsteps - 1
    if mma:
        _check_mma_rows(q=q, k=k_in, v=v)
        pkey = (key, Sq, Sk, B, Hkv, D, sm_count(q.device))
        starts, firsts, cover, _ = wl_partition(*pkey)
        part, nparts = _device_int32(("wl", pkey), (starts, firsts, cover), q.device), len(starts) - 1
        dq_acc = torch.empty(((len(firsts) - 1) if dq_whole else 1, B, Hq, Sq, D), **f32)
        dk_acc, dv_acc = (torch.empty((nparts, B, Hkv, strip_cols, D), **f32) for _ in range(2))
    else:
        part, nparts = None, 0
        dq_acc = torch.empty(((parts if dq_whole else 1), B, Hq, Sq, D), **f32)
        dk_acc, dv_acc = (torch.empty((B, Hkv, Sk, D), **f32) for _ in range(2))
    delta_buf = torch.empty((B, Hq, Sq), **f32) if o_in is not None else None
    lse = lse.contiguous()
    strides = _fused_strides(q, k_in, v, do, o_in, dq, dk, dv)
    ptr = lambda t: t.data_ptr() if t is not None else None
    status = _entry("fa2_flash_bwd_wl")(
        _build.DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Sk, D,
        q.data_ptr(), k_in.data_ptr(), v.data_ptr(), do.data_ptr(), ptr(o_in), lse.data_ptr(),
        ptr(delta), ptr(delta_buf), dq_acc.data_ptr(), dk_acc.data_ptr(), dv_acc.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), tbl.data_ptr(),
        tbl.data_ptr() + 4 * 8 * nsteps, parts, sub, strip_cols, int(dq_whole),
        lens.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), int(q_off), int(kv_off),
        int(bool(causal)), window[0], window[1], float(softmax_scale), float(k_mul),
        *dropout_c_args(dropout_p, dropout_seed), int(sq_real), int(sk_real), ptr(part),
        int(nparts), FUSED_BQ, fused_kv_tile(D), _build.stream_ptr(q.device))
    _build.check(status, "flash_bwd worklist launch")
    SCHEDULE_LAUNCHES["worklist"] += 1
    return dq, dk, dv


def flash_attn_backward_fused_wl_plain(q, k, v, do, o, lse, lens, q_off=0, kv_off=0, *,
                                       schedule, causal=True, softmax_scale, window=(-1, -1),
                                       dropout_p=0.0, dropout_seed=0, seqlen_q_real=None,
                                       seqlen_k_real=None, dlse=None):
    """The work-list kernel's plain twin, in fp32: walks the table of
    `schedule` (the `_worklist` key) chunk by chunk (`wl_partition`),
    vectorised over the kv heads, honouring each step's flags as the TPU
    kernel does: masked steps apply the causal / window mask and unmasked
    ones only the lengths; with one strip each row's dq is zeroed at
    WL_INIT_DQ and written at WL_WRITE_DQ. Each chunk sums dk / dv into its
    own partial and its rows' dq into its strip's; then the chunk partials
    of each strip are added in chunk order (dk, dv) and, with several
    strips, the strip partials in strip order (dq)."""
    table, _ = _worklist(*schedule)
    sub, nsub_strip, dq_whole = schedule[1], schedule[3], schedule[-1]
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    starts, firsts, _, _ = wl_partition(schedule, Sq, Sk, B, Hkv, D, sm_count(q.device))
    strip_cols = nsub_strip * sub
    k_p = _prescale_k(k, softmax_scale)
    delta = compute_delta(o, do, lse, dlse)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros(((len(firsts) - 1) if dq_whole else 1, B, Hq, Sq, D), **f32)
    dk_part, dv_part = (torch.zeros((len(starts) - 1, B, Hkv, strip_cols, D), **f32)
                        for _ in range(2))
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for c in range(len(starts) - 1):
        for g, iq, ws, flags, strip, *_ in table[starts[c]:starts[c + 1]].tolist():
            heads = slice(g, None, group)
            acc = dq_acc[strip if dq_whole else 0]
            rows = slice(iq * sub, min((iq + 1) * sub, Sq))
            cols = slice(ws * sub, min((ws + 1) * sub, Sk))
            if flags & WL_INIT_DQ and not dq_whole:
                acc[:, heads, rows] = 0.0
            if rows.start < rows.stop and cols.start < cols.stop:
                dqr, dkr, dvr = _fused_region_plain(
                    q, k_p, v, do, lse, delta, lens, q_off, kv_off, rows=rows, cols=cols,
                    causal=causal, window=window, masked=bool(flags & (WL_MASK_GEN | WL_MASK_TRI)),
                    g=g, dropout_p=dropout_p, dropout_seed=dropout_seed, seqlen_q_real=sq_real,
                    seqlen_k_real=sk_real)
                acc[:, heads, rows] += dqr
                local = slice(cols.start - strip * strip_cols, cols.stop - strip * strip_cols)
                dk_part[c][:, :, local] += dkr
                dv_part[c][:, :, local] += dvr
            if flags & WL_WRITE_DQ and not dq_whole:
                dq[:, heads, rows] = (acc[:, heads, rows] / LOG2E).to(dq.dtype)
    for st in range(len(firsts) - 1):
        if firsts[st] == firsts[st + 1]:
            continue
        cols = slice(st * strip_cols, min((st + 1) * strip_cols, Sk))
        dk_s, dv_s = dk_part[firsts[st]], dv_part[firsts[st]]
        for c in range(firsts[st] + 1, firsts[st + 1]):
            dk_s, dv_s = dk_s + dk_part[c], dv_s + dv_part[c]
        dk[:, :, cols] = (dk_s[:, :, :cols.stop - cols.start] * softmax_scale).to(dk.dtype)
        dv[:, :, cols] = dv_s[:, :, :cols.stop - cols.start].to(dv.dtype)
    if dq_whole:
        acc = dq_acc[0]
        for st in range(1, len(dq_acc)):
            acc = acc + dq_acc[st]
        dq[:] = (acc / LOG2E).to(dq.dtype)
    return dq, dk, dv


def flash_attn_backward(
    q: torch.Tensor,      # [B, Hq, Sq, D] (any strides, head dim contiguous)
    k: torch.Tensor,      # [B, Hkv, Sk, D]
    v: torch.Tensor,      # [B, Hkv, Sk, D]
    do: torch.Tensor,     # [B, Hq, Sq, D] cotangent of o
    o: torch.Tensor,      # [B, Hq, Sq, D] the forward's output
    lse: torch.Tensor,    # [B, Hq, Sq] fp32, base 2, the forward's
    lens: torch.Tensor,   # [B, 2] int32 (q_len, kv_len) global actual lengths
    q_off: int = 0,
    kv_off: int = 0,
    bias: Optional[torch.Tensor] = None,  # [1|B, 1|Hq, 1|Sq, 1|Sk]
    *,
    causal: bool,
    softmax_scale: float,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dlse: Optional[torch.Tensor] = None,  # [B, Hq, Sq] cotangent of lse
    compute_dbias: bool = False,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    seqlen_q_real: Optional[int] = None,   # real lengths: dropout counter, gates (default: Sq, Sk)
    seqlen_k_real: Optional[int] = None,
    static_skip: bool = False,   # the shift kv_len - q_len is sk_real - sq_real for every row
    varlen: bool = False,        # lens carry per-row lengths (a padding mask)
    fused: Optional[bool] = None,          # False: skip every schedule (JAX's two-pass)
    causal_split: Optional[bool] = None,   # force the split on / off (None: the gates decide)
    split_leaf: Optional[int] = None,      # the split's leaf length (default bwd_split_leaf_t)
    route: Optional[str] = None,           # force a schedule by name
    block_sizes: Optional[BlockSizes] = None,   # JAX's blocks: the padded shape the gates read
):
    """Returns (dq, dk, dv) in the input dtypes, plus dbias
    [bias.shape[0], bias.shape[1], Sq, Sk] in the bias dtype when
    `compute_dbias`. Bitwise repeatable (no atomics). The schedule is
    `backward_route`'s, on the chip of q's device (its tuning table)."""
    if compute_dbias and bias is None:
        raise ValueError("compute_dbias needs a bias")
    dropout_c_args(dropout_p, dropout_seed)
    B, Hq, Sq, D = q.shape
    chip = detect_chip(q.device)
    route = backward_route(
        Sq, k.shape[2], D, q.element_size(), causal=causal, group=Hq // k.shape[1],
        static_skip=static_skip, window=window, bias=bias, softcap=softcap, varlen=varlen,
        seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real, fused=fused,
        causal_split=causal_split, split_leaf=split_leaf, route=route, block_sizes=block_sizes,
        chip=chip)
    sched = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
                 seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real, dlse=dlse)
    if route == "tri_square":
        return flash_attn_backward_tri_square(q, k, v, do, o, lse, lens, q_off, kv_off, **sched)
    if route == "split":
        return _causal_split_backward(q, k, v, do, o, lse, lens, q_off, kv_off,
                                      leaf_t=split_leaf, block_sizes=block_sizes, chip=chip,
                                      **sched)
    if route == "worklist":
        Sq_p, Sk_p, Dp = jax_padded_shape(Sq, k.shape[2], D, q.element_size(), block_sizes, chip)
        sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
        sub, block_kv = causal_wl_bwd_config(causal, static_skip, tuple(window), varlen, softcap,
                                             Sq_p, Sk_p, sq_real, sk_real, Dp, Hq // k.shape[1],
                                             q.element_size())
        return flash_attn_backward_fused_wl(q, k, v, do, o, lse, lens, q_off, kv_off,
                                            causal=causal, window=window, sub=sub,
                                            block_kv=block_kv, **sched)
    return _generic_backward(q, k, v, do, o, lse, lens, q_off, kv_off, bias, causal=causal,
                             softmax_scale=softmax_scale, window=window, softcap=softcap,
                             dlse=dlse, compute_dbias=compute_dbias, dropout_p=dropout_p,
                             dropout_seed=dropout_seed, seqlen_q_real=seqlen_q_real,
                             seqlen_k_real=seqlen_k_real)
