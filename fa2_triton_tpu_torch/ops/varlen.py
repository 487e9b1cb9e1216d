"""Packed variable-length and block-sparse attention: the CUDA kernels'
wrappers, their plain twins and the public entry points.

Port of `fa2_triton_tpu/ops/varlen.py`. Documents of mixed length share one
packed token stream `[1, T, H, D]`, each starting at a multiple of
`align = max(block_q, block_kv)` (`pack_padded_batch`), so no kernel tile
straddles two documents. The host enumerates exactly the (q block, kv
block) pairs that carry work into a work list (`_build_schedule`, numpy,
copied verbatim: row layout below); block-sparse attention filters the same
list with a static block mask. On the TPU the list drives a sequential grid
(B7 `_varlen_fwd_kernel`, B8 `_varlen_dq_kernel` / `_varlen_dkdv_kernel`).
On the GPU the kernels of `csrc/varlen.cu` read it as a launch table: the
q-major list is sorted by packed q block, so a CSR row pointer over it gives
each 64-row q tile (forward, dq) the entries of its user block; the
kv-major list, with the GQA group index in column 7, does the same for each
64-row kv tile (dk/dv). The 16-bit (tensor-core) kernels also take the
tiles heaviest first (`_tile_order`): causal documents of mixed length give
tiles whose loops differ by up to 64x, and the long ones must not start
last. The forward and dq cover the same keys of the same entries, so dq
takes the forward's q-major table (`_VarlenCore` keeps it) and only the
kv-major one is built in the backward.

Work-list row layout (int32, [n_steps, 8]):
  0: packed q block   1: packed kv block
  2: q row offset in segment        3: kv col offset in segment
  4: segment q_len    5: segment kv_len
  6: init flag (first kv step of this q block)
     + 2*final flag (last kv step) + 4*masked flag (tile needs edge/diag)
  7: GQA group index (kv-major lists), else 0

Per segment, causal masking is bottom-right aligned on the true lengths
(shift = kv_len - q_len), lse is base 2, and every position outside a
segment's live rows is written, not skipped: o = 0, lse = -inf and
dq = dk = dv = 0 exactly. Masked scores are -inf under a finite running-max
floor, so a row with no kept column ends with o = 0 and lse = -inf even
when its block survives the block mask (the JAX kernel's finite -1e30 mask
averages v there instead: ROADMAP.md queue C).

Dropout is the JAX package's packed stream (`_packed_dropout_bits`,
`utils/rng.py:packed_dropout_keep_mask`): an element of q head h at GLOBAL
packed row / column is kept iff hash(hash(hash(seed, h), row), col) >=
dropout_threshold(p), with `flash_attn_func`'s seed contract; block-sparse
attention packs B x S into T and uses the same stream.

fp16 follows JAX (`fa2_triton_tpu/ops/varlen.py:751-752, 832-833`):
`flash_attn_varlen_func` and `flash_attn_blocksparse_func` compute fp16
inputs in fp32 (the FMA kernels) and return fp16. The tensor-core kernels'
fp16 instantiations stay reachable through `flash_attn_varlen_forward` /
`flash_attn_varlen_backward`.

CPU tensors take the `*_plain` twins (per segment, dense fp32, never a
T x T matrix); CUDA tensors always launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fa2_triton_tpu_torch.ops import _build
from fa2_triton_tpu_torch.ops.attention import pad_head_dim, pad_last, resolve_dropout_seed
from fa2_triton_tpu_torch.ops.flash_bwd import _mma_layout, compute_delta
from fa2_triton_tpu_torch.ops.flash_fwd import _check_cuda_args, _vec, dropout_c_args
from fa2_triton_tpu_torch.utils import (
    LOG2E, default_softmax_scale, packed_dropout_keep_mask, round_up_to_multiple)

F_INIT, F_FINAL, F_MASKED = 1, 2, 4

# The CUDA kernels' output tiles (csrc/varlen.cu): 64 rows, each nested in
# one user block (past head dim 256 a 16-bit dk/dv block and an fp32 block
# own half of one). csrc/varlen.cu is built for the dense kernels' tiled head
# dims (flash_fwd.HEAD_DIMS, 384 / 512 in varlen_wide.cu) and not past them
# yet: `pad_head_dim(..., family=PACKED)` raises there on CUDA tensors.
TILE_ROWS = 64
PACKED = "the packed (varlen / block-sparse) kernels are"

# Kernel launches since the last reset, per kernel (the smoke test reads
# these to show the packed path went through the kernels).
LAUNCHES = {"varlen_fwd": 0, "varlen_dq": 0, "varlen_dkdv": 0}
_KERNEL_IDS = {"varlen_fwd": 0, "varlen_dq": 1, "varlen_dkdv": 2}

_c_fn = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------ packing -----------------------------------

def pack_padded_batch(xs: Sequence[torch.Tensor], lens: Sequence[int], align: int = 512):
    """Pack right-padded [B, S, ...] tensors into [1, T, ...] with each
    sequence start aligned to `align` (so kernel blocks never straddle a
    segment boundary). `lens` are Python ints: the packing layout is a host
    decision. Gaps between segments are zero.

    Returns (packed list, seg_starts [B] np.int32, T)."""
    lens = [int(l) for l in lens]
    starts = np.cumsum([0] + [round_up_to_multiple(max(l, 1), align)
                              for l in lens[:-1]]).astype(np.int32)
    T = int(starts[-1]) + round_up_to_multiple(max(lens[-1], 1), align)
    packed = []
    for x in xs:
        out = x.new_zeros((1, T) + tuple(x.shape[2:]))
        for b in range(x.shape[0]):
            rows = x[b, :lens[b]]
            out[0, int(starts[b]):int(starts[b]) + rows.shape[0]] = rows
        packed.append(out)
    return packed, starts, T


def unpack_padded_batch(xp: torch.Tensor, seg_starts: np.ndarray, lens: Sequence[int],
                        seqlen: int) -> torch.Tensor:
    """Inverse of `pack_padded_batch` for one tensor: [1, T, ...] ->
    [B, seqlen, ...] (padded tail positions zero-filled)."""
    rows = []
    for s0, l in zip(seg_starts, lens):
        row = xp[:, int(s0):int(s0) + min(int(l), seqlen)]
        pad = seqlen - row.shape[1]
        if pad:
            row = torch.cat([row, row.new_zeros((1, pad) + tuple(row.shape[2:]))], dim=1)
        rows.append(row)
    return torch.cat(rows, dim=0)


# --------------------------- schedule builder -----------------------------

def _seg_extents(seg_starts, T: int):
    starts = [int(s) for s in seg_starts]
    return [b - a for a, b in zip(starts, starts[1:] + [int(T)])]

def _build_schedule(seg_starts, seg_exts, seg_qlens, seg_kvlens,
                    block_q, block_kv, causal, kv_major=False, group=1,
                    keep_block=None):
    """Host-side work list (see module docstring).

    `seg_exts` are each segment's PADDED extents (align-multiples tiling the
    packed stream): every output block in an extent gets at least one step
    so dead tails are zero-filled deterministically (padded positions must
    carry exact zeros — the packed cotangents feed straight into user
    arrays). kv_major=True emits the dk/dv ordering: consecutive steps share
    a kv block (iterating the GQA group inside it); init/final then refer to
    the kv block's accumulation.

    `keep_block(seg, jq, jk) -> bool` optionally filters (q block, kv block)
    pairs at BLOCK granularity (segment-local indices) — block-sparse
    attention: filtered pairs never enter the grid, and the softmax
    normalizes over the surviving blocks only. Rows/columns whose every
    pair is filtered zero-fill via the dummy masked step."""
    rows: List[List[int]] = []
    B = len(seg_qlens)
    for s in range(B):
        q0 = int(seg_starts[s])
        ext = int(seg_exts[s])
        qlen, kvlen = int(seg_qlens[s]), int(seg_kvlens[s])
        shift = kvlen - qlen
        nq = ext // block_q
        nkv = ext // block_kv
        live_q = [jq for jq in range(nq) if jq * block_q < qlen]
        if kv_major:
            for jk in range(nkv):
                kv_lo = jk * block_kv
                steps = []
                for g in range(group):
                    for jq in live_q:
                        q_lo = jq * block_q
                        if (causal and kv_lo < kvlen
                                and q_lo + block_q - 1 + shift < kv_lo):
                            continue  # entire q block above the diagonal
                        if kv_lo >= kvlen:
                            continue  # dead kv tail: zero-fill only
                        if (keep_block is not None
                                and not keep_block(s, jq, jk)):
                            continue  # block-sparse: filtered out
                        masked = (
                            kv_lo + block_kv > kvlen
                            or q_lo + block_q > qlen
                            or (causal
                                and kv_lo + block_kv - 1 > q_lo + shift)
                        )
                        steps.append([
                            (q0 + q_lo) // block_q, (q0 + kv_lo) // block_kv,
                            q_lo, kv_lo, qlen, kvlen,
                            F_MASKED * masked, g,
                        ])
                if not steps:
                    # Dead or fully-filtered kv block: one masked step whose
                    # compute contributes zero; the finalizer writes zeros.
                    # kvlen is clamped to kv_lo so every column of the block
                    # fails `col < kvlen` — a LIVE kv block that block-sparse
                    # filtered out must not pick up q-block-0's real ds/p.
                    steps = [[q0 // block_q, (q0 + kv_lo) // block_kv,
                              0, kv_lo, qlen, min(kvlen, kv_lo),
                              F_MASKED, 0]]
                steps[0][6] |= F_INIT
                steps[-1][6] |= F_FINAL
                rows += steps
        else:
            for jq in range(nq):
                q_lo = jq * block_q
                steps = []
                if q_lo < qlen:
                    for jk in range(nkv):
                        kv_lo = jk * block_kv
                        if kv_lo >= kvlen:
                            break
                        if causal and kv_lo > q_lo + block_q - 1 + shift:
                            break  # strictly-future kv blocks
                        if (keep_block is not None
                                and not keep_block(s, jq, jk)):
                            continue  # block-sparse: filtered out
                        masked = (
                            kv_lo + block_kv > kvlen
                            or (causal
                                and kv_lo + block_kv - 1 > q_lo + shift)
                        )
                        steps.append([
                            (q0 + q_lo) // block_q, (q0 + kv_lo) // block_kv,
                            q_lo, kv_lo, qlen, kvlen,
                            F_MASKED * masked, 0,
                        ])
                if not steps:
                    # Dead row block (padded tail / negative-shift causal)
                    # or a live one block-sparse filtered entirely: one
                    # masked step so the finalizer zero-fills it. qlen is
                    # clamped to q_lo so every row of the block fails
                    # `row < qlen` in the finalizer (o = 0, lse = -inf —
                    # which in turn zeroes the backward's p for these rows).
                    steps = [[(q0 + q_lo) // block_q, q0 // block_kv,
                              q_lo, 0, min(qlen, q_lo), kvlen,
                              F_MASKED, 0]]
                steps[0][6] |= F_INIT
                steps[-1][6] |= F_FINAL
                rows += steps
    return np.asarray(rows, np.int32)


def _mask_keep_fn(mask_bits):
    """Rebuild a keep_block callable from the hashable mask encoding
    (n_kv_blocks, per-q-block row bitmasks as ints) carried in the
    custom_vjp nondiff meta. None means dense (no filter)."""
    if mask_bits is None:
        return None
    _, rows = mask_bits

    def keep(s, jq, jk):
        return bool((rows[jq] >> jk) & 1)

    return keep


def encode_block_mask(block_mask) -> Tuple[int, Tuple[int, ...]]:
    """Encode a bool [n_q_blocks, n_kv_blocks] array as a hashable
    (n_kv_blocks, row-bitmask-ints) tuple for the custom_vjp meta."""
    m = np.asarray(block_mask, bool)
    assert m.ndim == 2, "block_mask must be [n_q_blocks, n_kv_blocks]"
    rows = tuple(int(sum(1 << j for j in range(m.shape[1]) if m[i, j]))
                 for i in range(m.shape[0]))
    return (int(m.shape[1]), rows)


# ------------------------------ launchers ---------------------------------

def _segments(seg_starts, T, seg_qlens, seg_kvlens, block_q, block_kv):
    """[(start, extent, q_len, kv_len)] per segment, after checking the
    packed layout the work lists assume."""
    starts = [int(s) for s in seg_starts]
    if not len(starts) == len(seg_qlens) == len(seg_kvlens):
        raise ValueError("seg_starts, seg_qlens and seg_kvlens differ in length")
    align = max(block_q, block_kv)
    if T % align or any(s % align for s in starts):
        raise ValueError("packed segment starts and the total T must be multiples of "
                         "max(block_q, block_kv); use pack_padded_batch")
    exts = _seg_extents(starts, T)
    segs = list(zip(starts, exts, (int(l) for l in seg_qlens), (int(l) for l in seg_kvlens)))
    for s0, ext, qlen, kvlen in segs:
        if ext <= 0 or not (0 <= qlen <= ext and 0 <= kvlen <= ext):
            raise ValueError(f"segment at {s0}: lengths ({qlen}, {kvlen}) do not fit its "
                             f"extent {ext}; starts must increase")
    return segs


def _segment_keep(seg, ext, qlen, kvlen, causal, block_q, block_kv, keep_block, device):
    """keep [ext, ext]: the element mask of one segment (lengths, causal
    diagonal, and the block mask expanded to elements)."""
    row = torch.arange(ext, device=device)[:, None]
    col = torch.arange(ext, device=device)[None]
    keep = (row < qlen) & (col < kvlen)
    if causal:
        keep = keep & (col <= row + (kvlen - qlen))
    if keep_block is not None:
        blk = torch.tensor([[keep_block(seg, jq, jk) for jk in range(ext // block_kv)]
                            for jq in range(ext // block_q)], dtype=torch.bool, device=device)
        keep = keep & blk.repeat_interleave(block_q, 0).repeat_interleave(block_kv, 1)
    return keep


def _segment_drop(a, ext, Hq, dropout_p, seed, device):
    """[Hq, ext, ext] dropout factors of the segment at packed row a: 1 /
    (1 - p) where the packed stream keeps the element, else 0."""
    idx = a + torch.arange(ext, device=device)
    keep = packed_dropout_keep_mask(seed, dropout_p, torch.arange(Hq, device=device), idx, idx)
    return torch.where(keep, torch.tensor(1.0 / (1.0 - dropout_p), device=device),
                       torch.zeros((), device=device))


def _live_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [H, ext, D] as fp32 with rows at or past n zeroed (gaps may hold
    NaN, and 0 * NaN would leak)."""
    ok = torch.arange(x.shape[1], device=x.device)[:, None] < n
    return torch.where(ok, x.float(), torch.zeros((), device=x.device))


def flash_attn_varlen_forward_plain(
    q, k, v, seg_starts, seg_qlens, seg_kvlens, *, causal: bool, softmax_scale: float,
    block_q: int = 512, block_kv: int = 512, keep_block=None,
    dropout_p: float = 0.0, dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: each segment dense
    in fp32 with its element mask. Returns (o [1, Hq, T, D] in q's dtype,
    lse [1, Hq, T] fp32 base 2; o = 0 and lse = -inf where a row keeps no
    column). Dropout drops p from P V only and scales o by 1 / (1 - p)."""
    _, Hq, T, D = q.shape
    g = Hq // k.shape[1]
    dev = q.device
    o = torch.zeros((1, Hq, T, D), dtype=torch.float32, device=dev)
    lse = torch.full((1, Hq, T), float("-inf"), device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    segs = _segments(seg_starts, T, seg_qlens, seg_kvlens, block_q, block_kv)
    for s, (a, ext, qlen, kvlen) in enumerate(segs):
        keep = _segment_keep(s, ext, qlen, kvlen, causal, block_q, block_kv, keep_block, dev)
        qs = _live_rows(q[0, :, a:a + ext], qlen)
        ks = _live_rows(k[0, :, a:a + ext], kvlen).repeat_interleave(g, 0)
        vs = _live_rows(v[0, :, a:a + ext], kvlen).repeat_interleave(g, 0)
        s2 = torch.where(keep, torch.matmul(qs, ks.transpose(-1, -2)) * (softmax_scale * LOG2E),
                         neg_inf)
        m = s2.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp2(s2 - m)
        del s2
        l = p.sum(dim=-1, keepdim=True)
        if dropout_p > 0.0:
            p = p * _segment_drop(a, ext, Hq, dropout_p, dropout_seed, dev)
        o[0, :, a:a + ext] = torch.matmul(p, vs) / torch.where(l > 0, l, torch.ones_like(l))
        lse[0, :, a:a + ext] = torch.where(l > 0, m + torch.log2(l), neg_inf)[..., 0]
    return o.to(q.dtype), lse


def flash_attn_varlen_backward_plain(
    q, k, v, do, o, lse, seg_starts, seg_qlens, seg_kvlens, *, causal: bool,
    softmax_scale: float, block_q: int = 512, block_kv: int = 512,
    dlse: Optional[torch.Tensor] = None, keep_block=None,
    dropout_p: float = 0.0, dropout_seed: int = 0,
):
    """The backward kernels' function in plain PyTorch, per segment in fp32:
    p = exp2(s * log2e - lse) on kept elements, ds = p (do v^T - delta),
    dq = scale ds k, dk = scale ds^T q and dv = p^T do summed over the GQA
    group; with dropout, do v^T and dv's p carry the packed mask times
    1 / (1 - p). Returns (dq, dk, dv) in the input dtypes, exactly 0 outside
    the segments' live rows."""
    _, Hq, T, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    dev = q.device
    zero = torch.zeros((), device=dev)
    delta = compute_delta(o, do, lse, dlse)
    dq = torch.zeros((1, Hq, T, D), device=dev)
    dk = torch.zeros((1, Hkv, T, D), device=dev)
    dv = torch.zeros((1, Hkv, T, D), device=dev)
    segs = _segments(seg_starts, T, seg_qlens, seg_kvlens, block_q, block_kv)
    for s, (a, ext, qlen, kvlen) in enumerate(segs):
        lse_s = lse[0, :, a:a + ext]
        finite = torch.isfinite(lse_s)
        keep = _segment_keep(s, ext, qlen, kvlen, causal, block_q, block_kv, keep_block, dev)
        keep = keep[None] & finite[..., None]
        qs, dos = (_live_rows(x[0, :, a:a + ext], qlen) for x in (q, do))
        ks, vs = (_live_rows(x[0, :, a:a + ext], kvlen).repeat_interleave(g, 0) for x in (k, v))
        sc = torch.matmul(qs, ks.transpose(-1, -2)) * (softmax_scale * LOG2E)
        p = torch.where(keep, torch.exp2(sc - torch.where(finite, lse_s, zero)[..., None]), zero)
        del sc
        dp = torch.matmul(dos, vs.transpose(-1, -2))
        p_dv = p
        if dropout_p > 0.0:
            drop = _segment_drop(a, ext, Hq, dropout_p, dropout_seed, dev)
            dp = dp * drop
            p_dv = p * drop
            del drop
        ds = torch.where(keep, p * (dp - delta[0, :, a:a + ext, None]), zero)
        del dp, keep
        dq[0, :, a:a + ext] = torch.matmul(ds, ks) * softmax_scale
        dk[0, :, a:a + ext] = (torch.matmul(ds.transpose(-1, -2), qs) * softmax_scale).view(
            Hkv, g, ext, D).sum(1)
        dv[0, :, a:a + ext] = torch.matmul(p_dv.transpose(-1, -2), dos).view(Hkv, g, ext, D).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _entry():
    global _c_fn
    if _c_fn is None:
        fn = _build.load().fa2_varlen
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        U = ctypes.c_uint
        fn.argtypes = [I] * 6 + [P] * 10 + [P] * 4 + [I] * 3 + [F] + [I, U, U, F, P]
        fn.restype = I
        _c_fn = fn
    return _c_fn


def _uses_kernels(q: torch.Tensor) -> bool:
    """True for CUDA tensors (the kernels), False for CPU ones (the plain
    twins); raises on any other device."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"varlen takes CPU or CUDA tensors, got {q.device}")
    return q.device.type == "cuda"


def _check_cuda_layout(q, k, v, block_q, block_kv):
    """Raise on what the kernels do not take; 16-bit q / k / v need 16-byte
    rows (the tensor-core kernels' cp.async copies)."""
    _check_cuda_args(q, k, v, vec=_vec(q))
    pad_head_dim(q.shape[3], q.device, PACKED)   # raises past the kernels' head dims
    if q.shape[0] != 1 or k.shape[2] != q.shape[2]:
        raise ValueError(f"packed q / k / v must be [1, H, T, D] with one T, got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    if block_q % TILE_ROWS or block_kv % TILE_ROWS:
        raise ValueError(f"the varlen kernels' {TILE_ROWS}-row tiles must nest in the user "
                         f"blocks: block_q and block_kv must be multiples of {TILE_ROWS}, "
                         f"got ({block_q}, {block_kv})")


def _tile_work(work, T, block_q, block_kv, causal, kv_major=False) -> np.ndarray:
    """[T // TILE_ROWS] int64: what the loops of the 16-bit kernels cover for
    each 64-row tile, summed over the entries of its user block. A q tile
    (forward, dq) counts the keys [0, hi) of each entry's kv block that its
    live rows need: up to kv_len and the causal edge of its last live row. A
    kv tile (dk/dv, `kv_major`) counts the q rows of each entry's q block
    that keep its first live column: from the causal edge to q_len. A tile
    with no live row counts 0."""
    w = np.asarray(work, np.int64).reshape(-1, 8)
    block = block_kv if kv_major else block_q
    sub = TILE_ROWS * np.arange(block // TILE_ROWS)
    first = w[:, 3 if kv_major else 2, None] + sub          # the tile's first row in the segment
    live = np.clip(w[:, 5 if kv_major else 4, None] - first, 0, TILE_ROWS)
    shift = (w[:, 5] - w[:, 4])[:, None]
    if kv_major:
        rows_lo = np.maximum(0, first - shift - w[:, 2, None]) if causal else 0
        amount = np.minimum(block_q, w[:, 4] - w[:, 2])[:, None] - rows_lo
    else:
        amount = np.minimum(block_kv, w[:, 5] - w[:, 3])[:, None]
        if causal:
            amount = np.minimum(amount, first + live + shift - w[:, 3, None])
    amount = np.where(live > 0, np.maximum(amount, 0), 0)
    tile = (w[:, 1 if kv_major else 0, None] * block + sub) // TILE_ROWS
    return np.bincount(tile.ravel(), weights=amount.ravel(),
                       minlength=T // TILE_ROWS).astype(np.int64)


def _tile_order(work, T, block_q, block_kv, causal, kv_major=False) -> np.ndarray:
    """The 64-row tiles of the packed stream heaviest first by `_tile_work`,
    ties by index: a permutation of range(T // TILE_ROWS), int32."""
    load = _tile_work(work, T, block_q, block_kv, causal, kv_major)
    return np.argsort(-load, kind="stable").astype(np.int32)


def _launch_table(segs, block_q, block_kv, causal, keep_block, T, device, kv_major=False,
                  group=1, order=False):
    """The work list, a CSR row pointer over it (the entries of packed q
    block (kv block, when kv_major) u are rows [rowptr[u], rowptr[u + 1]))
    and, with `order`, the tiles heaviest first (`_tile_order`), in one
    int32 tensor on the device. Returns it and the addresses of the three
    arrays (None for an order not asked for)."""
    starts = [s[0] for s in segs]
    work = _build_schedule(starts, [s[1] for s in segs], [s[2] for s in segs],
                           [s[3] for s in segs], block_q, block_kv, causal,
                           kv_major=kv_major, group=group, keep_block=keep_block).reshape(-1, 8)
    keys = work[:, 1 if kv_major else 0]
    if np.any(np.diff(keys) < 0):
        raise AssertionError("work list not sorted by its output block")
    n_blocks = T // (block_kv if kv_major else block_q)
    rowptr = np.searchsorted(keys, np.arange(n_blocks + 1), side="left").astype(np.int32)
    parts = [work.ravel(), rowptr]
    if order:
        parts.append(_tile_order(work, T, block_q, block_kv, causal, kv_major))
    table = torch.from_numpy(np.concatenate(parts)).to(device)
    base, n_work = table.data_ptr(), work.size
    return table, (base, base + 4 * n_work, base + 4 * (n_work + rowptr.size) if order else None)


def _launch(name: str, args) -> None:
    _build.check(_entry()(_KERNEL_IDS[name], *args), f"{name} launch")
    LAUNCHES[name] += 1


def _strides(*ts) -> ctypes.Array:
    """Head and row strides of the 8 tensor slots q, k, v, do, o, dq, dk, dv
    (None = unused)."""
    vals = []
    for t in ts:
        vals += [t.stride(1), t.stride(2)] if t is not None else [0, 0]
    return (ctypes.c_longlong * 16)(*vals)


def flash_attn_varlen_forward(
    q: torch.Tensor,          # [1, Hq, T, D] packed (any strides, head dim contiguous)
    k: torch.Tensor,          # [1, Hkv, T, D]
    v: torch.Tensor,          # [1, Hkv, T, D]
    seg_starts, seg_qlens: Sequence[int], seg_kvlens: Sequence[int],
    *, causal: bool, softmax_scale: float, block_q: int = 512, block_kv: int = 512,
    keep_block=None, dropout_p: float = 0.0, dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o [1, Hq, T, D] in q's dtype, a BHSD view of BSHD memory;
    lse [1, Hq, T] fp32, base 2)."""
    o, lse, _ = _varlen_forward(q, k, v, seg_starts, seg_qlens, seg_kvlens, causal=causal,
                                softmax_scale=softmax_scale, block_q=block_q, block_kv=block_kv,
                                keep_block=keep_block, dropout_p=dropout_p,
                                dropout_seed=dropout_seed)
    return o, lse


def _varlen_forward(q, k, v, seg_starts, seg_qlens, seg_kvlens, *, causal, softmax_scale,
                    block_q, block_kv, keep_block, dropout_p, dropout_seed):
    """`flash_attn_varlen_forward`, also returning the q-major launch table
    the kernel ran on (`_forward_launch`'s; None for CPU tensors or an empty
    stream), which the backward's dq launch can take."""
    drop = dropout_c_args(dropout_p, dropout_seed)
    if not _uses_kernels(q):
        return (*flash_attn_varlen_forward_plain(
            q, k, v, seg_starts, seg_qlens, seg_kvlens, causal=causal,
            softmax_scale=softmax_scale, block_q=block_q, block_kv=block_kv,
            keep_block=keep_block, dropout_p=dropout_p, dropout_seed=dropout_seed), None)
    _check_cuda_layout(q, k, v, block_q, block_kv)
    _, Hq, T, D = q.shape
    segs = _segments(seg_starts, T, seg_qlens, seg_kvlens, block_q, block_kv)
    o = torch.empty((1, T, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((1, Hq, T), dtype=torch.float32, device=q.device)
    if T == 0 or Hq == 0:
        return o, lse, None
    q_table = _forward_launch(q, k, v, o, lse, segs, causal=causal, softmax_scale=softmax_scale,
                              block_q=block_q, block_kv=block_kv, keep_block=keep_block,
                              drop=drop)
    return o, lse, q_table


def _forward_launch(q, k, v, o, lse, segs, *, causal, softmax_scale, block_q, block_kv,
                    keep_block, drop):
    """The forward's launch on the q-major table with its tiles heaviest
    first (the 16-bit kernel reads the order; the fp32 one ignores it).
    Returns the table (`_launch_table`'s tensor and addresses): dq's loops
    cover the same keys, so it is bitwise the table dq would build."""
    _, Hq, T, D = q.shape
    table = _launch_table(segs, block_q, block_kv, causal, keep_block, T, q.device, order=True)
    _launch("varlen_fwd", (
        _build.DTYPE_CODES[q.dtype], Hq, k.shape[1], T, D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), lse.data_ptr(), None,
        None, None, None, *table[1],
        ctypes.cast(_strides(q, k, v, None, o, None, None, None), ctypes.c_void_p),
        block_q, block_kv, int(bool(causal)), float(softmax_scale), *drop,
        _build.stream_ptr(q.device)))
    return table


def flash_attn_varlen_backward(
    q, k, v, do, o, lse,      # packed [1, H, T, D] / lse [1, Hq, T]
    seg_starts, seg_qlens: Sequence[int], seg_kvlens: Sequence[int],
    *, causal: bool, softmax_scale: float, block_q: int = 512, block_kv: int = 512,
    dlse: Optional[torch.Tensor] = None, keep_block=None,
    dropout_p: float = 0.0, dropout_seed: int = 0, q_table=None,
):
    """Returns (dq, dk, dv) in the input dtypes, BHSD views of BSHD memory,
    exactly 0 outside the segments' live rows. Bitwise repeatable (no
    atomics). `q_table`: the forward's q-major launch table for this layout
    (`_varlen_forward`'s third result), which dq then takes instead of
    building it anew."""
    drop = dropout_c_args(dropout_p, dropout_seed)
    kw = dict(causal=causal, softmax_scale=softmax_scale, block_q=block_q, block_kv=block_kv,
              dlse=dlse, keep_block=keep_block, dropout_p=dropout_p, dropout_seed=dropout_seed)
    if not _uses_kernels(q):
        return flash_attn_varlen_backward_plain(q, k, v, do, o, lse, seg_starts, seg_qlens,
                                                seg_kvlens, **kw)
    _check_cuda_layout(q, k, v, block_q, block_kv)
    _, Hq, T, D = q.shape
    Hkv = k.shape[1]
    for name, t in (("do", do), ("o", o)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be like q {tuple(q.shape)}, got {tuple(t.shape)} on {t.device}")
    if do.dtype != q.dtype:
        raise TypeError(f"do must have q's dtype {q.dtype}, got {do.dtype}")
    if lse.shape != (1, Hq, T) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("lse must be an fp32 [1, Hq, T] tensor on q's device")
    segs = _segments(seg_starts, T, seg_qlens, seg_kvlens, block_q, block_kv)
    do = _mma_layout(do)
    delta = compute_delta(o, do, lse, dlse)
    lse = lse.contiguous()
    dq = torch.empty((1, T, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((1, T, Hkv, D), dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((1, T, Hkv, D), dtype=v.dtype, device=q.device).transpose(1, 2)
    if T == 0 or Hq == 0:
        return dq, dk, dv
    _backward_launches(q, k, v, do, lse, delta, dq, dk, dv, segs, causal=causal,
                       softmax_scale=softmax_scale, block_q=block_q, block_kv=block_kv,
                       keep_block=keep_block, drop=drop, q_table=q_table)
    return dq, dk, dv


def _backward_launches(q, k, v, do, lse, delta, dq, dk, dv, segs, *, causal, softmax_scale,
                       block_q, block_kv, keep_block, drop, q_table=None) -> None:
    """The dq launch on the q-major table (`q_table`, the forward's, else
    built here), then the dk/dv launch on the kv-major one, each with its
    tiles heaviest first."""
    _, Hq, T, D = q.shape
    Hkv = k.shape[1]
    strides = ctypes.cast(_strides(q, k, v, do, None, dq, dk, dv), ctypes.c_void_p)
    common = (_build.DTYPE_CODES[q.dtype], Hq, Hkv, T, D,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), None, lse.data_ptr(),
              delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (block_q, block_kv, int(bool(causal)), float(softmax_scale), *drop,
            _build.stream_ptr(q.device))
    for name, kv_major in (("varlen_dq", False), ("varlen_dkdv", True)):
        table, ptrs = (q_table if q_table is not None and not kv_major else _launch_table(
            segs, block_q, block_kv, causal, keep_block, T, q.device, kv_major=kv_major,
            group=Hq // Hkv if kv_major else 1, order=True))
        _launch(name, common + (*ptrs, strides) + tail)


# ---------------------------- public wrapper ------------------------------

class _VarlenCore(torch.autograd.Function):
    """o, lse = packed attention(q, k, v) on [1, H, T, D] views; the static
    layout `meta` = (starts, q_lens, kv_lens, causal, scale, block_q,
    block_kv, dropout_p, dropout seed, encoded block mask or None) is not
    differentiated (the backward regenerates the forward's dropout mask from
    the same seed, and its dq launch takes the forward's q-major table)."""

    @staticmethod
    def forward(ctx, q, k, v, meta):
        starts, qlens, kvlens, causal, scale, bq, bkv, p, seed, mask = meta
        o, lse, ctx.q_table = _varlen_forward(
            q, k, v, starts, qlens, kvlens, causal=causal, softmax_scale=scale,
            block_q=bq, block_kv=bkv, keep_block=_mask_keep_fn(mask), dropout_p=p,
            dropout_seed=seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = meta
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        starts, qlens, kvlens, causal, scale, bq, bkv, p, seed, mask = ctx.meta
        dq, dk, dv = flash_attn_varlen_backward(
            q, k, v, do, o, lse, starts, qlens, kvlens, causal=causal, softmax_scale=scale,
            block_q=bq, block_kv=bkv, dlse=dlse, keep_block=_mask_keep_fn(mask), dropout_p=p,
            dropout_seed=seed, q_table=ctx.q_table)
        return dq, dk, dv, None


def _upcast_fp16(*xs):
    """fp16 tensors widened to fp32 (JAX's packed entry points compute fp16
    in fp32); others as they are."""
    return tuple(x.float() if x.dtype == torch.float16 else x for x in xs)


def flash_attn_varlen_func(
    q: torch.Tensor,               # [T, Hq, D] or [1, T, Hq, D] packed tokens
    k: torch.Tensor,               # [T, Hkv, D]
    v: torch.Tensor,
    cu_seqlens: Sequence[int],     # [B+1] static packed segment boundaries
    seqlens: Optional[Sequence[int]] = None,  # true lens (default: from cu)
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    return_lse: bool = False,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_rng: Optional[torch.Generator] = None,
):
    """Zero-waste varlen attention over a packed token stream, differentiable.

    `cu_seqlens` are the aligned segment starts (multiples of
    max(block_q, block_kv); see `pack_padded_batch`) plus the total T;
    `seqlens` give each segment's true length (default: the full aligned
    extent). Segments attend only within themselves, causally if requested.
    Returns the output like q, and with `return_lse` the base-2 lse
    [1, Hq, T] ([Hq, T] for 3-D q). Dropout takes `flash_attn_func`'s seed
    contract (exactly one of `dropout_seed` / `dropout_rng` when
    `dropout_p > 0`) and the packed stream of the module docstring. CUDA
    tensors take any head_dim <= 512 (zero-padded for the kernels)."""
    seed = resolve_dropout_seed(dropout_p, dropout_seed, dropout_rng)
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = (x[None] for x in (q, k, v))
    B = len(cu_seqlens) - 1
    starts = tuple(int(s) for s in cu_seqlens[:-1])
    T = int(cu_seqlens[-1])
    if q.shape[1] != T or k.shape[1] != T or v.shape != k.shape:
        raise ValueError(f"packed q / k / v {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not hold T = cu_seqlens[-1] = {T} tokens")
    if seqlens is None:
        seqlens = [int(cu_seqlens[i + 1]) - int(cu_seqlens[i]) for i in range(B)]
    seqlens = tuple(int(l) for l in seqlens)
    scale = float(softmax_scale) if softmax_scale is not None else default_softmax_scale(q.shape[-1])
    align = max(block_q, block_kv)
    if any(s % align for s in starts) or T % align:
        raise ValueError("packed segment starts must be aligned to max(block_q, block_kv); "
                         "use pack_padded_batch")
    meta = (starts, seqlens, seqlens, bool(causal), scale, block_q, block_kv, float(dropout_p),
            seed, None)
    out_dtype = q.dtype
    q, k, v = _upcast_fp16(q, k, v)
    D = q.shape[-1]
    Dp = pad_head_dim(D, q.device, PACKED)
    o, lse = _VarlenCore.apply(*(pad_last(x, Dp).transpose(1, 2) for x in (q, k, v)), meta)
    out = o.transpose(1, 2)[..., :D].to(out_dtype)
    if squeeze:
        out, lse = out[0], lse[0]
    if return_lse:
        return out, lse
    return out


def flash_attn_blocksparse_func(
    q: torch.Tensor,               # [B, S, Hq, D]
    k: torch.Tensor,               # [B, S, Hkv, D]
    v: torch.Tensor,
    block_mask,                    # static bool [ceil(S/bq), ceil(S/bkv)]
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    return_lse: bool = False,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_rng: Optional[torch.Generator] = None,
):
    """Block-sparse attention (BigBird / Longformer style): the softmax runs
    over exactly the (q block, kv block) pairs whose `block_mask` entry is
    True, intersected with the causal lower triangle when `causal`; the
    filtered pairs never enter the work list. Rows that keep no column
    return zeros with lse = -inf and get zero gradients. Differentiable,
    deterministic, GQA via Hq % Hkv == 0. Returns [B, S, Hq, D], and with
    `return_lse` the base-2 lse [B, Hq, S]. Dropout as in
    `flash_attn_varlen_func`, on the packed stream of [1, B * S_pad]."""
    seed = resolve_dropout_seed(dropout_p, dropout_seed, dropout_rng)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k / v must be [B, S, Hkv, D] like q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError("num_heads_q must be a multiple of num_heads_kv")
    align = max(block_q, block_kv)
    S_pad = round_up_to_multiple(S, align)
    m = np.asarray(block_mask, bool)
    nq_b, nkv_b = S_pad // block_q, S_pad // block_kv
    if m.shape not in ((nq_b, nkv_b), (-(-S // block_q), -(-S // block_kv))):
        raise ValueError(f"block_mask {m.shape} != ({nq_b}, {nkv_b})")
    if m.shape != (nq_b, nkv_b):   # padded tail blocks: dead anyway
        mm = np.zeros((nq_b, nkv_b), bool)
        mm[:m.shape[0], :m.shape[1]] = m
        m = mm
    scale = float(softmax_scale) if softmax_scale is not None else default_softmax_scale(D)
    out_dtype = q.dtype
    q, k, v = _upcast_fp16(q, k, v)
    Dp = pad_head_dim(D, q.device, PACKED)

    def pack(x):
        # [B, S, H, D] -> [1, H, B*S_pad, Dp], a view when S_pad == S and Dp == D
        if S_pad != S or Dp != D:
            x = F.pad(x, (0, Dp - D, 0, 0, 0, S_pad - S))
        return x.reshape(1, B * S_pad, x.shape[2], Dp).transpose(1, 2)

    starts = tuple(b * S_pad for b in range(B))
    lens = (S,) * B
    meta = (starts, lens, lens, bool(causal), scale, block_q, block_kv, float(dropout_p), seed,
            encode_block_mask(m))
    o, lse = _VarlenCore.apply(pack(q), pack(k), pack(v), meta)
    out = o.transpose(1, 2).reshape(B, S_pad, Hq, Dp)[:, :S, :, :D].to(out_dtype)
    if return_lse:
        return out, lse.reshape(Hq, B, S_pad)[:, :, :S].transpose(0, 1)
    return out
