"""FlashAttention-2 forward: the CUDA kernel's wrapper and its plain twin.

Port of `fa2_triton_tpu/ops/flash_fwd.py:flash_attn_forward` as the serving
prefill and the training forward reach it: the TPU's `_fwd_kernel` (B1, with
its additive bias), `_fwd_tri_square_kernel` (B9) and
`_fwd_causal_strip_kernel` (B10), and the split schedule's B9 diag, B11
rectangle and B1 merge, all become `csrc/flash_fwd.cu`: 16-bit inputs run
its tensor-core kernel (`mma.sync` tiles), fp32 inputs its FMA kernel.
Tensors are
BHSD views with any strides (the head dim contiguous), so the BSHD public API
hands them over without a copy. Per batch row, `lens[b] = (q_len, kv_len)`
are global actual lengths and `q_off` / `kv_off` place this call's rows and
columns in the global frame; causal and window masks are bottom-right
aligned on (q_len, kv_len). An additive bias broadcastable to
[B, Hq, Sq, Sk] is indexed by q head and read through the strides of its
broadcast view (zero on broadcast dims), never materialised.

Dropout (`dropout_p > 0`) is the JAX package's counter-hash stream
(`utils/rng.py`): element (b, h, row, col) of the call, at global row
q_off + i and column kv_off + j, is kept iff
counter_hash(seed, ((b * Hq + h) * seqlen_q_real + row) * seqlen_k_real +
col) >= dropout_threshold(p). The softmax sum and lse stay undropped; only
the P V product sees the mask, and o is scaled by 1 / (1 - p).

Causal routing (`flash_attn_forward` with `causal` and `static_skip`) is
the JAX package's (`fa2_triton_tpu/ops/flash_fwd.py:1267-1328`), with its
gates copied verbatim and evaluated at the shape the JAX API pads to (head
dim to 128 lanes, lengths to its blocks: `jax_padded_shape`) and the real
lengths: the short tri-square range
(B9, here the generic kernel), the split schedule (B9 diag leaves, then B11
rectangles merged in place into the running (o, lse): B1 merge) and the
whole-strip causal forward (B10: the generic kernel's causal call, counted
apart), else the generic kernel. The port pads nothing: its kernels clip to
the tensors' lengths. The split's launches are calls of the same kernels
through their own C entry points: the diag a causal call with a leaf length
(`fa2_flash_fwd_causal`), a rectangle a call on the region, with and
without the merge epilogue (`fa2_flash_fwd_rect`).

CPU tensors take the plain twins (`flash_attn_forward_plain`, and for the
schedules `flash_attn_forward_causal_diag_plain` / `_rect_plain`: the same
on leaves or rectangles, with `merge_softmax_partials`) through the same
routing; CUDA tensors always launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops import _build
from fa2_triton_tpu_torch.utils import LOG2E, dropout_keep_mask, dropout_threshold

# Launches of csrc/flash_fwd.cu since the last reset (the smoke test reads
# this to show the served path went through the kernel).
LAUNCHES = 0
# Launches of the causal schedules, csrc/flash_fwd.cu's kernels all, counted
# here and not in LAUNCHES: the strip (B10), the diag (B9 diag), the
# rectangle without and with its merge epilogue (B11, B1 merge).
SCHEDULE_LAUNCHES = dict.fromkeys(("causal_strip", "causal_diag", "rect", "rect_merge"), 0)

# The row tile of the Hopper kernels (attn_tiles.cuh's TM, flash_fwd.cu's
# FwdMmaCfg::BQ), passed to fa2_flash_fwd, which refuses other values. It
# stands in for the TPU's sub-tile in the schedules' alignment
# preconditions; a diag leaf is a whole number of tiles.
TILE_ROWS = 64

HEAD_DIMS = (64, 128, 256)
# The attention entry points zero-pad other head dims up to the next of
# HEAD_DIMS; past the last, the dq and dk/dv tiles need more shared memory
# than a Hopper block has (ROADMAP.md queue C, "Head dims").
MAX_HEAD_DIM = HEAD_DIMS[-1]

_P, _I, _L, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_uint
# argtypes of each C entry point. The split's two share a head: (dtype,
# leaf or merge, B, Hq, Hkv, Sq, Sk, D, 6 pointers, 12 strides, q_off, kv_off,
# scale, 4 dropout args, Sq_real, Sk_real).
_SCHED_HEAD = [_I] * 8 + [_P] * 6 + [_L] * 12 + [_I, _I, _F, _I, _U, _U, _F, _I, _I]
_ARGTYPES = {
    "fa2_flash_fwd": ([_I] * 7 + [_P] * 6 + [_L] * 12 + [_P, _I] + [_L] * 4 + [_I] * 5 + [_F, _F]
                      + [_I, _U, _U, _F, _I, _I, _I, _P]),
    "fa2_flash_fwd_causal": _SCHED_HEAD + [_P],
    "fa2_flash_fwd_rect": _SCHED_HEAD + [_I] * 6 + [_P],
}
_c_fns = {}


def _entry(name: str = "fa2_flash_fwd"):
    if name not in _c_fns:
        fn = getattr(_build.load(), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _c_fns[name] = fn
    return _c_fns[name]


def reset_launches() -> None:
    """Zero LAUNCHES and every SCHEDULE_LAUNCHES count."""
    global LAUNCHES
    LAUNCHES = 0
    for name in SCHEDULE_LAUNCHES:
        SCHEDULE_LAUNCHES[name] = 0


def dropout_c_args(dropout_p: float, dropout_seed: int):
    """(on, seed as uint32, threshold, 1 / (1 - p)): the kernels' dropout
    arguments."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p == 0.0:
        return 0, 0, 0, 1.0
    return 1, int(dropout_seed) & 0xFFFFFFFF, dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p)


def dropout_mask(B, Hq, Sq, Sk, q_off, kv_off, dropout_p, dropout_seed, seqlen_q_real,
                 seqlen_k_real, device):
    """keep [B, Hq, Sq, Sk]: the kernels' dropout mask of a call whose rows
    and columns sit at q_off / kv_off."""
    rows = q_off + torch.arange(Sq, device=device)
    cols = kv_off + torch.arange(Sk, device=device)
    return dropout_keep_mask(dropout_seed, dropout_p, B, Hq, rows, cols, seqlen_q_real,
                             seqlen_k_real)


def _masks(lens, q_off, kv_off, Sq, Sk, causal, window, device):
    """keep [B, 1, Sq, Sk]: the kernel's positional mask."""
    B = lens.shape[0]
    q_len = lens[:, 0].to(device=device, dtype=torch.int64).view(B, 1, 1, 1)
    kv_len = lens[:, 1].to(device=device, dtype=torch.int64).view(B, 1, 1, 1)
    row = (q_off + torch.arange(Sq, device=device)).view(1, 1, Sq, 1)
    col = (kv_off + torch.arange(Sk, device=device)).view(1, 1, 1, Sk)
    shift = kv_len - q_len
    keep = (col < kv_len) & (row < q_len)
    if causal:
        keep = keep & (col <= row + shift)
    elif window[1] >= 0:
        keep = keep & (col <= row + shift + window[1])
    if window[0] >= 0:
        keep = keep & (col >= row + shift - window[0])
    return keep


def bias_view(bias: torch.Tensor, q: torch.Tensor, Sk: int) -> torch.Tensor:
    """The [B, Hq, Sq, Sk] broadcast view of an additive bias (no copy), as
    the kernels read it. The bias must be 4-D and on q's device."""
    B, Hq, Sq, _ = q.shape
    if bias.dim() != 4:
        raise ValueError(f"attention bias must be 4-D [1|B, 1|Hq, 1|Sq, 1|Sk], got {tuple(bias.shape)}")
    if bias.device != q.device:
        raise ValueError(f"bias is on {bias.device}, q on {q.device}")
    if bias.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"attention bias must be fp32/fp16/bf16, got {bias.dtype}")
    return bias.expand(B, Hq, Sq, Sk)


def flash_attn_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
    q_off: int = 0, kv_off: int = 0, bias: Optional[torch.Tensor] = None, *,
    causal: bool, softmax_scale: float,
    window: Tuple[int, int] = (-1, -1), softcap: float = 0.0,
    dropout_p: float = 0.0, dropout_seed: int = 0,
    seqlen_q_real: Optional[int] = None, seqlen_k_real: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, computed in fp32.

    q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], lens [B, 2] int, bias
    broadcastable to [B, Hq, Sq, Sk] (added after the softcap). Returns o
    like q and lse [B, Hq, Sq] fp32 in log2 units (-inf and o = 0 on dead
    rows). Dropout's mask comes from `utils/rng.py` (`dropout_mask`), with
    the real lengths defaulting to the call's Sq, Sk."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * softmax_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if bias is not None:
        s = s + bias.float()
    keep = _masks(lens, q_off, kv_off, Sq, Sk, causal, window, q.device)
    s2 = torch.where(keep, s * LOG2E, torch.tensor(float("-inf"), device=q.device))
    m = s2.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l > 0, l, torch.ones_like(l))
    if dropout_p > 0.0:
        keep_d = dropout_mask(B, Hq, Sq, Sk, q_off, kv_off, dropout_p, dropout_seed,
                              seqlen_q_real or Sq, seqlen_k_real or Sk, q.device)
        p = torch.where(keep_d, p, torch.zeros((), device=q.device))
        denom = denom * (1.0 - dropout_p)
    o = torch.matmul(p, vf) / denom
    lse = torch.where(l > 0, m + torch.log2(l), torch.tensor(float("-inf"), device=q.device))
    return o.to(q.dtype), lse[..., 0]


def _check_cuda_args(q, k, v, lens=None, vec=4):
    """Raise on BHSD q / k / v (and [B, 2] lens, when given) that the
    attention kernels do not take: `vec`-element vector loads (4 for the
    FMA kernels; 8, i.e. 16-byte cp.async rows, for the 16-bit tensor-core
    forward)."""
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the attention kernels take fp32/fp16/bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    for name, t in (("k", k), ("v", v), ("lens", lens)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    B, Hq, Sq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)} / {tuple(v.shape)} for q {tuple(q.shape)}")
    if Hq % k.shape[1] != 0:
        raise ValueError("num_heads_q must be a multiple of num_heads_kv")
    if D not in HEAD_DIMS:
        raise ValueError(f"the attention kernels take head_dim in {HEAD_DIMS} (the entry points "
                         f"zero-pad any head_dim <= {MAX_HEAD_DIM} to one of them; larger ones "
                         f"wait for a new tiling, ROADMAP.md queue C 'Head dims'), got {D}")
    if lens is not None and (lens.shape != (B, 2) or lens.dtype != torch.int32
                             or not lens.is_contiguous()):
        raise ValueError("lens must be a contiguous int32 [B, 2] tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # Vector loads: last dim contiguous, the other strides and the base
        # address aligned.
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous, strides a multiple "
                             f"of {vec} elements and the base 16-byte aligned; got strides "
                             f"{t.stride()}")


def _vec(q) -> int:
    """The vector width in elements `_check_cuda_args` holds q / k / v / o
    to: 8 (16-byte cp.async rows) for the 16-bit tensor-core kernel, 4 for
    the fp32 FMA kernel."""
    return 8 if q.element_size() == 2 else 4


def _generic_forward(q, k, v, lens, q_off, kv_off, bias, *, causal, softmax_scale, window,
                     softcap, dropout_p, dropout_seed, seqlen_q_real, seqlen_k_real):
    """csrc/flash_fwd.cu (B1, B9) on CUDA tensors, its plain twin on CPU
    ones."""
    global LAUNCHES
    dropout_c_args(dropout_p, dropout_seed)   # raises on a p outside [0, 1)
    if q.device.type == "cpu":
        return flash_attn_forward_plain(
            q, k, v, lens, q_off, kv_off, bias, causal=causal,
            softmax_scale=softmax_scale, window=window, softcap=softcap, dropout_p=dropout_p,
            dropout_seed=dropout_seed, seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    out = _flash_fwd_launch(q, k, v, lens, q_off, kv_off, bias, causal=causal,
                            softmax_scale=softmax_scale, window=window, softcap=softcap,
                            dropout_p=dropout_p, dropout_seed=dropout_seed,
                            seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    if out[1].numel():
        LAUNCHES += 1
    return out


def _flash_fwd_launch(q, k, v, lens, q_off, kv_off, bias, *, causal, softmax_scale, window,
                      softcap, dropout_p, dropout_seed, seqlen_q_real, seqlen_k_real):
    """One launch of csrc/flash_fwd.cu (none for an empty output): the
    tensor-core kernel for 16-bit inputs, the FMA kernel for fp32."""
    drop = dropout_c_args(dropout_p, dropout_seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd takes CPU or CUDA tensors, got {q.device}")
    _check_cuda_args(q, k, v, lens, vec=_vec(q))
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    bv = bias_view(bias, q, Sk) if bias is not None else None
    o, lse = _new_out(q, Sq)
    if B == 0 or Sq == 0 or Hq == 0:
        return o, lse
    status = _entry()(
        _build.DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Sk, D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        lens.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        bv.data_ptr() if bv is not None else None,
        _build.DTYPE_CODES[bv.dtype] if bv is not None else 0,
        *(bv.stride() if bv is not None else (0, 0, 0, 0)),
        int(q_off), int(kv_off), int(bool(causal)), int(window[0]), int(window[1]),
        float(softmax_scale), float(softcap), *drop,
        int(seqlen_q_real or Sq), int(seqlen_k_real or Sk), TILE_ROWS,
        _build.stream_ptr(q.device),
    )
    _build.check(status, "flash_fwd launch")
    return o, lse


# ---------------------------------------------------------------------------
# Causal routing and its gates: `fa2_triton_tpu/ops/flash_fwd.py` l.830-966,
# copied verbatim (pure Python), including the v5e-derived VMEM budgets, so
# that the same call takes the same schedule in both packages.


def causal_strip_ok(causal, static_skip, window, bias, varlen, Sq, Sk,
                    sq_real, sk_real, head_dim, sub=512,
                    vmem_budget=8192 * 128, softcap=0.0, dtype_bytes=2):
    """Eligibility for the whole-strip causal kernel (JAX l.830): the TPU's
    K and V strips must fit VMEM together (strictly below Sk * head_dim ==
    8192 * 128), the shift must be static, non-negative and sub-aligned, the
    final diagonal tile inside the strip, 2-byte dtypes only, no softcap."""
    shift = sk_real - sq_real
    return (causal and static_skip and window == (-1, -1) and bias is None
            and not varlen and softcap == 0.0
            and Sq % sub == 0 and Sk % sub == 0 and Sq >= 2 * sub
            and shift >= 0 and shift % sub == 0 and Sq + shift <= Sk
            and dtype_bytes <= 2
            and Sk * head_dim < vmem_budget)


def tri_square_ok(causal, static_skip, window, bias, Sq, Sk,
                  sq_real, sk_real, head_dim=128, sub=256, max_seq=2048,
                  softcap=0.0, dtype_bytes=2):
    """Eligibility for the static-triangular small-S causal kernel (JAX
    l.856): the whole padded sequence in the TPU's VMEM budget (in bytes),
    sub-aligned lengths and shift, no softcap."""
    return (causal and static_skip and window == (-1, -1) and bias is None
            and softcap == 0.0
            and Sq <= max_seq and Sk <= max_seq
            and Sq * head_dim * dtype_bytes <= 2048 * 128 * 2
            and Sk * head_dim * dtype_bytes <= 2048 * 128 * 2
            and Sq % sub == 0 and Sk % sub == 0
            and (sk_real - sq_real) % sub == 0)


def causal_split_rects(n: int):
    """Below-diagonal rectangles (row0, col0, nrows, ncols) in leaf units
    (JAX l.898): rows [mid, hi) attend every column in [lo, mid) unmasked,
    and the two halves recurse; total area n * (n - 1) / 2 leaves."""
    rects = []

    def rec(lo, hi):
        if hi - lo <= 1:
            return
        mid = (lo + hi) // 2
        rects.append((mid, lo, hi - mid, mid - lo))
        rec(lo, mid)
        rec(mid, hi)

    rec(0, n)
    return rects


def split_leaf_t(head_dim: int, dtype_bytes: int = 2) -> int:
    """Largest diagonal leaf whose q/k/v/o strips fit the tri-square VMEM
    budget (JAX l.919); 0 below 512."""
    cap = 2048 * 128 * 2 // (head_dim * dtype_bytes)
    t = 1 << (cap.bit_length() - 1) if cap > 0 else 0
    return t if t >= 512 else 0


def causal_split_ok(causal, static_skip, window, bias, varlen, softcap,
                    Sq, Sk, sq_real, sk_real, head_dim, leaf_t=None,
                    dtype_bytes=2):
    """Eligibility for the split schedule (JAX l.928): square zero-shift
    causal with no bias / window / softcap / varlen; by default exactly two
    leaves, with an explicit leaf any n >= 2."""
    T = leaf_t if leaf_t is not None else split_leaf_t(head_dim, dtype_bytes)
    n_ok = (Sq // T == 2) if (leaf_t is None and T > 0) else (
        T > 0 and Sq // T >= 2)
    return (causal and static_skip and window == (-1, -1) and bias is None
            and not varlen and softcap == 0.0 and T > 0 and T % 128 == 0
            and Sq == Sk and sq_real == sk_real
            and Sq % T == 0 and n_ok)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# The JAX API's padding (`fa2_triton_tpu/ops/attention.py:207-222`): the head
# dim to a multiple of 128 lanes, and each sequence to the larger of its
# forward and backward blocks from `choose_block_sizes`
# (`fa2_triton_tpu/ops/tuning.py:36-50, 110-190, 255-268`, its v5e static
# prior, copied verbatim for the only calls the gates can pass: causal, with
# no bias and no window; the persisted tuning table is queue A item 3's).


def _waste_aware(seqlen: int, candidates, max_waste_frac: float = 0.125) -> int:
    sp = _round_up(max(seqlen, 1), 128)
    for cand in candidates:
        c = min(cand, sp)
        padded = _round_up(sp, c)
        if padded - seqlen <= max(seqlen, 1) * max_waste_frac:
            return c
    return min(candidates[-1], sp)


def _compatible(b_fwd: int, b_bwd: int) -> int:
    lo, hi = min(b_fwd, b_bwd), max(b_fwd, b_bwd)
    return b_bwd if hi % lo == 0 else b_fwd


def _divisor_block(block: int, cap: int) -> int:
    if block <= cap:
        return block
    c = (cap // 128) * 128
    while c > 128 and block % c != 0:
        c -= 128
    return c


def jax_padded_shape(Sq: int, Sk: int, head_dim: int, dtype_bytes: int) -> Tuple[int, int, int]:
    """(Sq, Sk, head_dim) as the JAX API pads a causal call with no bias and
    no window before it routes; `dtype_bytes` is the computing dtype's."""
    Dp = _round_up(head_dim, 128)
    cands = (1024, 512, 256, 128)
    bq, bkv = (_waste_aware(Sq, cands), _waste_aware(Sk, cands)) if Dp <= 256 else (128, 256)
    if dtype_bytes >= 4:
        bq, bkv = min(bq, 512), min(bkv, 512)
    bq = min(bq, _round_up(max(Sq, 1), 128))
    bkv = min(bkv, _round_up(max(Sk, 1), 128))
    if Dp <= 128:
        bq_b, bkv_b = (512, 512) if dtype_bytes >= 4 else (1024, 1024)
        bq_b = min(bq_b, _round_up(max(Sq, 1), 128))
        bkv_b = min(bkv_b, _round_up(max(Sk, 1), 128))
        bq_b, bkv_b = _compatible(bq, bq_b), _compatible(bkv, bkv_b)
    else:
        bq_b, bkv_b = _divisor_block(bq, 256), _divisor_block(bkv, 256)
    return _round_up(Sq, max(bq, bq_b)), _round_up(Sk, max(bkv, bkv_b)), Dp


def _env_disables(name: str) -> bool:
    """JAX's kill switches (FA2_DISABLE_SPLIT / FA2_DISABLE_STRIP), read
    at call time."""
    return os.environ.get(name, "0").lower() in ("1", "true", "yes")


def forward_route(Sq: int, Sk: int, head_dim: int, dtype_bytes: int, *, causal: bool,
                  static_skip: bool = False, window: Tuple[int, int] = (-1, -1), bias=None,
                  softcap: float = 0.0, varlen: bool = False,
                  seqlen_q_real: Optional[int] = None, seqlen_k_real: Optional[int] = None,
                  tri_square: Optional[bool] = None, causal_strip: Optional[bool] = None,
                  causal_split: Optional[bool] = None, split_leaf: Optional[int] = None) -> str:
    """The schedule `flash_attn_forward` takes: "tri_square", "split",
    "strip" or "generic". JAX's order and gates (flash_fwd.py:1267-1328),
    at the shape the JAX API pads to (`jax_padded_shape`) and the real
    lengths (default Sq, Sk); `dtype_bytes` is the element size the kernels
    compute in. A route forced on (True) whose gate fails raises
    ValueError; forced off (False) it is skipped."""
    Sq_p, Sk_p, Dp = jax_padded_shape(Sq, Sk, head_dim, dtype_bytes)
    sq_real = seqlen_q_real if seqlen_q_real is not None else Sq
    sk_real = seqlen_k_real if seqlen_k_real is not None else Sk
    window = tuple(window)
    gates = (
        ("tri_square", tri_square, tri_square_ok(
            causal, static_skip, window, bias, Sq_p, Sk_p, sq_real, sk_real, head_dim=Dp,
            softcap=softcap, dtype_bytes=dtype_bytes)),
        ("split", causal_split, causal_split_ok(
            causal, static_skip, window, bias, varlen, softcap, Sq_p, Sk_p, sq_real, sk_real,
            Dp, leaf_t=split_leaf, dtype_bytes=dtype_bytes)
         and not _env_disables("FA2_DISABLE_SPLIT")),
        ("strip", causal_strip, causal_strip_ok(
            causal, static_skip, window, bias, varlen, Sq_p, Sk_p, sq_real, sk_real,
            head_dim=Dp, softcap=softcap, dtype_bytes=dtype_bytes)
         and not _env_disables("FA2_DISABLE_STRIP")),
    )
    for route, forced, ok in gates:
        if forced if forced is not None else ok:
            if not ok:
                raise ValueError(f"{route} forced but its preconditions are not met (Sq {Sq}, Sk "
                                 f"{Sk}, head_dim {head_dim}, {dtype_bytes}-byte dtype)")
            return route
    return "generic"


def flash_attn_forward(
    q: torch.Tensor,      # [B, Hq, Sq, D] (any strides, head dim contiguous)
    k: torch.Tensor,      # [B, Hkv, Sk, D]
    v: torch.Tensor,      # [B, Hkv, Sk, D]
    lens: torch.Tensor,   # [B, 2] int32 (q_len, kv_len) global actual lengths
    q_off: int = 0,
    kv_off: int = 0,
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, Hq, Sq, Sk]
    *,
    causal: bool,
    softmax_scale: float,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    seqlen_q_real: Optional[int] = None,   # real lengths: dropout counter, gates (default: Sq, Sk)
    seqlen_k_real: Optional[int] = None,
    static_skip: bool = False,   # the shift kv_len - q_len is sk_real - sq_real for every row
    varlen: bool = False,        # lens carry per-row lengths (a padding mask)
    tri_square: Optional[bool] = None,   # force a schedule on / off (None: the gates decide)
    causal_strip: Optional[bool] = None,
    causal_split: Optional[bool] = None,
    split_leaf: Optional[int] = None,    # the split's leaf length (default split_leaf_t)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o [B, Hq, Sq, D] in q's dtype, lse [B, Hq, Sq] fp32, log2).

    `o` is a BHSD view of BSHD-contiguous memory, so `o.transpose(1, 2)` is
    the contiguous BSHD output. The schedule is `forward_route`'s."""
    route = forward_route(
        q.shape[2], k.shape[2], q.shape[3], q.element_size(), causal=causal,
        static_skip=static_skip, window=window, bias=bias, softcap=softcap, varlen=varlen,
        seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real, tri_square=tri_square,
        causal_strip=causal_strip, causal_split=causal_split, split_leaf=split_leaf)
    sched = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
                 seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    if route == "split":
        return _causal_split_forward(q, k, v, lens, q_off, kv_off, leaf_t=split_leaf, **sched)
    if route == "strip":
        return flash_attn_forward_causal_strip(q, k, v, lens, q_off, kv_off, **sched)
    if route == "tri_square":
        return flash_attn_forward_tri_square(q, k, v, lens, q_off, kv_off, **sched)
    return _generic_forward(q, k, v, lens, q_off, kv_off, bias, causal=causal, window=window,
                            softcap=softcap, **sched)


def merge_softmax_partials(o1, lse1, o2, lse2):
    """Combine two normalized partial attentions over disjoint column sets
    of the same rows (JAX l.951): o [..., D], lse [...] base-2 with -inf on
    dead rows, which carry weight 0 (both dead: o = 0, lse = -inf, no NaN).
    A dropout compensation 1 / (1 - p) in both o factors through. Returns
    (o fp32, lse fp32)."""
    lse1, lse2 = lse1.float(), lse2.float()
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w1 = torch.exp2(lse1 - m_safe)
    w2 = torch.exp2(lse2 - m_safe)
    l = w1 + w2
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) * inv[..., None]
    lse = torch.where(l > 0, m_safe + torch.log2(l), torch.full_like(l, float("-inf")))
    return o, lse


def _reals(q, k, seqlen_q_real, seqlen_k_real):
    return (seqlen_q_real if seqlen_q_real is not None else q.shape[2],
            seqlen_k_real if seqlen_k_real is not None else k.shape[2])


def _schedule_launch(kernel: str, q, k, v, lens, q_off, kv_off, o, lse, *, softmax_scale,
                     dropout_p, dropout_seed, seqlen_q_real, seqlen_k_real, tail: List[int]):
    """Launch a split call of csrc/flash_fwd.cu, the diag through
    `fa2_flash_fwd_causal` ("causal_diag": tail = [leaf]) or a rectangle
    through `fa2_flash_fwd_rect` ("rect", "rect_merge": tail = [lse_rows,
    row0, row_end, col0, col_end, out_row0]), writing o / lse, and count
    it. 16-bit q / k / v (and a merge's o) need 16-byte rows, as
    `_flash_fwd_launch`'s."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd takes CPU or CUDA tensors, got {q.device}")
    _check_cuda_args(q, k, v, lens, vec=_vec(q))
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    rect = kernel.startswith("rect")
    mode = int(kernel == "rect_merge") if rect else tail[0]
    if B and Hq and Sq:
        status = _entry("fa2_flash_fwd_rect" if rect else "fa2_flash_fwd_causal")(
            _build.DTYPE_CODES[q.dtype], mode, B, Hq, Hkv, Sq, Sk, D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), lens.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(q_off), int(kv_off), float(softmax_scale),
            *dropout_c_args(dropout_p, dropout_seed), int(sq_real), int(sk_real),
            *(tail if rect else []), _build.stream_ptr(q.device))
        _build.check(status, f"flash_fwd {kernel} launch")
        SCHEDULE_LAUNCHES[kernel] += 1
    return o, lse


def _new_out(q, rows):
    """o [B, Hq, rows, D] (a BHSD view of BSHD memory) and lse [B, Hq, rows]."""
    B, Hq, _, D = q.shape
    return (torch.empty((B, rows, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2),
            torch.empty((B, Hq, rows), dtype=torch.float32, device=q.device))


def flash_attn_forward_tri_square(q, k, v, lens, q_off=0, kv_off=0, *, softmax_scale,
                                  dropout_p=0.0, dropout_seed=0, seqlen_q_real=None,
                                  seqlen_k_real=None):
    """B9, the short causal forward (JAX l.585), with its precondition
    (l.602) on the shift sk_real - sq_real, a multiple of the row tile
    (TILE_ROWS in place of the TPU's sub-tile; the port does not pad, so the
    lengths themselves are free). On the GPU one kernel, csrc/flash_fwd.cu,
    computes B1 and B9, so this launches it causal."""
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    if (sk_real - sq_real) % TILE_ROWS:
        raise ValueError(f"tri_square needs a shift that is a multiple of {TILE_ROWS}, got "
                         f"{sk_real - sq_real}")
    return _generic_forward(q, k, v, lens, q_off, kv_off, None, causal=True, window=(-1, -1),
                            softcap=0.0, softmax_scale=softmax_scale, dropout_p=dropout_p,
                            dropout_seed=dropout_seed, seqlen_q_real=seqlen_q_real,
                            seqlen_k_real=seqlen_k_real)


def flash_attn_forward_causal_strip(q, k, v, lens, q_off=0, kv_off=0, *, softmax_scale,
                                    dropout_p=0.0, dropout_seed=0, seqlen_q_real=None,
                                    seqlen_k_real=None):
    """B10, the whole-strip causal forward (JAX l.779): csrc/flash_fwd.cu's
    kernel, causal, counted under SCHEDULE_LAUNCHES["causal_strip"]. It is
    the generic kernel's causal call, so their o and lse are equal bit for
    bit; the strip's gain (no mask test on tiles below the diagonal, longest
    rows first) is that kernel's own. JAX's preconditions (l.792-793), with
    the row tile TILE_ROWS in place of the TPU's sub-tile: a static shift
    sk_real - sq_real >= 0, a multiple of it, with the last row's diagonal
    inside the keys (Sq + shift <= Sk)."""
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    shift = sk_real - sq_real
    if not (shift >= 0 and shift % TILE_ROWS == 0 and q.shape[2] + shift <= k.shape[2]):
        raise ValueError(f"causal_strip needs a shift >= 0, a multiple of {TILE_ROWS}, with the "
                         f"last row's diagonal inside the keys; got shift {shift}, Sq "
                         f"{q.shape[2]}, Sk {k.shape[2]}")
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    if q.device.type == "cpu":
        return flash_attn_forward_plain(q, k, v, lens, q_off, kv_off, causal=True, **kw)
    out = _flash_fwd_launch(q, k, v, lens, q_off, kv_off, None, causal=True, window=(-1, -1),
                            softcap=0.0, **kw)
    if out[1].numel():
        SCHEDULE_LAUNCHES["causal_strip"] += 1
    return out


def flash_attn_forward_causal_diag(q, k, v, lens, q_off=0, kv_off=0, *, T, softmax_scale,
                                   dropout_p=0.0, dropout_seed=0, seqlen_q_real=None,
                                   seqlen_k_real=None):
    """B9 diag (JAX l.969): every diagonal T x T causal leaf in one launch,
    csrc/flash_fwd.cu's kernel called causal with a leaf length (the longest
    tiles of every leaf first). Local row r attends
    only columns of its own leaf [T * (r // T), T * (r // T + 1)); global
    offsets and real lengths keep validity and dropout those of the whole
    problem. Full-size (o, lse). Needs Sq == Sk and T a multiple of the
    64-row tile. JAX's Sq % T == 0 holds on the length its API pads to; the
    port does not pad, so its last leaf may be short."""
    Sq = q.shape[2]
    if not (Sq == k.shape[2] and T > 0 and T % TILE_ROWS == 0):
        raise ValueError(f"causal_diag needs Sq == Sk and T a multiple of {TILE_ROWS}; got Sq "
                         f"{Sq}, Sk {k.shape[2]}, T {T}")
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    if q.device.type == "cpu":
        return flash_attn_forward_causal_diag_plain(q, k, v, lens, q_off, kv_off, T=T, **kw)
    return _schedule_launch("causal_diag", q, k, v, lens, q_off, kv_off, *_new_out(q, Sq),
                            tail=[T], **kw)


def flash_attn_forward_causal_diag_plain(q, k, v, lens, q_off=0, kv_off=0, *, T, softmax_scale,
                                         dropout_p=0.0, dropout_seed=0, seqlen_q_real=None,
                                         seqlen_k_real=None):
    """The diag kernel's plain twin: `flash_attn_forward_plain`, causal, on
    each leaf's rows and columns at their global offsets (the leaf mask)."""
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    Sq = q.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for l0 in range(0, Sq, T):
        leaf = slice(l0, min(l0 + T, Sq))
        o[:, :, leaf], lse[:, :, leaf] = flash_attn_forward_plain(
            q[:, :, leaf], k[:, :, leaf], v[:, :, leaf], lens, q_off + l0, kv_off + l0,
            causal=True, softmax_scale=softmax_scale, dropout_p=dropout_p,
            dropout_seed=dropout_seed, seqlen_q_real=sq_real, seqlen_k_real=sk_real)
    return o, lse


def flash_attn_forward_rect(q, k, v, lens, q_off=0, kv_off=0, *, row0, col0, nrows, ncols,
                            softmax_scale, dropout_p=0.0, dropout_seed=0, seqlen_q_real=None,
                            seqlen_k_real=None, merge_prev=None):
    """B11 (JAX l.1041): non-causal attention of q rows [row0, row0 + nrows)
    against K/V columns [col0, col0 + ncols) of the full tensors, cut to
    their lengths, with global offsets for validity and dropout
    (csrc/flash_fwd.cu's kernel, not causal, on the region). Returns
    region-sized (o, lse).

    `merge_prev=(o_prev, lse_prev)`, full-size like this call's output and
    holding a normalized partial over disjoint columns, is merge mode (B1
    merge, JAX's `_fwd_kernel_merge`): the rectangle's rows are merged into
    those tensors in place (o in q's dtype), and they are returned."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    if not (0 <= row0 < Sq and 0 <= col0 < Sk and nrows > 0 and ncols > 0):
        raise ValueError(f"rect rows [{row0}, +{nrows}) / columns [{col0}, +{ncols}) do not meet "
                         f"the tensors' {Sq} rows and {Sk} columns")
    row_end, col_end = min(row0 + nrows, Sq), min(col0 + ncols, Sk)
    if merge_prev is not None:
        o_prev, lse_prev = merge_prev
        if (o_prev.shape != q.shape or o_prev.dtype != q.dtype or lse_prev.shape != (B, Hq, Sq)
                or lse_prev.dtype != torch.float32 or o_prev.device != q.device
                or lse_prev.device != q.device):
            raise ValueError("merge_prev must be (o like q, lse [B, Hq, Sq] fp32) on q's device")
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=sq_real, seqlen_k_real=sk_real)
    if q.device.type == "cpu":
        return flash_attn_forward_rect_plain(q, k, v, lens, q_off, kv_off, row0=row0, col0=col0,
                                             nrows=nrows, ncols=ncols, merge_prev=merge_prev, **kw)
    if merge_prev is None:
        o, lse = _new_out(q, row_end - row0)
        tail, kernel = [row_end - row0, row0, row_end, col0, col_end, row0], "rect"
    else:
        o, lse = merge_prev
        _check_cuda_args(o, k, v, vec=_vec(q))   # the epilogue reads and writes o like q
        if not lse.is_contiguous():
            raise ValueError("merge_prev's lse must be contiguous")
        tail, kernel = [Sq, row0, row_end, col0, col_end, 0], "rect_merge"
    return _schedule_launch(kernel, q, k, v, lens, q_off, kv_off, o, lse, tail=tail, **kw)


def flash_attn_forward_rect_plain(q, k, v, lens, q_off=0, kv_off=0, *, row0, col0, nrows, ncols,
                                  softmax_scale, dropout_p=0.0, dropout_seed=0,
                                  seqlen_q_real=None, seqlen_k_real=None, merge_prev=None):
    """The rect kernel's plain twin: `flash_attn_forward_plain`, not causal,
    on the region at its global offsets; with `merge_prev`,
    `merge_softmax_partials` of the previous rows and the region's fp32
    partial, written back in place in o's dtype, as the kernel does."""
    sq_real, sk_real = _reals(q, k, seqlen_q_real, seqlen_k_real)
    rows = slice(row0, min(row0 + nrows, q.shape[2]))
    cols = slice(col0, min(col0 + ncols, k.shape[2]))
    # fp32 in: the partial stays unrounded until the merge, as in the kernel.
    o, lse = flash_attn_forward_plain(
        q[:, :, rows].float(), k[:, :, cols].float(), v[:, :, cols].float(), lens,
        q_off + row0, kv_off + col0, causal=False, softmax_scale=softmax_scale,
        dropout_p=dropout_p, dropout_seed=dropout_seed, seqlen_q_real=sq_real,
        seqlen_k_real=sk_real)
    if merge_prev is None:
        return o.to(q.dtype), lse
    o_prev, lse_prev = merge_prev
    o_m, lse_m = merge_softmax_partials(o_prev[:, :, rows], lse_prev[:, :, rows], o, lse)
    o_prev[:, :, rows] = o_m.to(o_prev.dtype)
    lse_prev[:, :, rows] = lse_m
    return o_prev, lse_prev


def _causal_split_forward(q, k, v, lens, q_off=0, kv_off=0, *, softmax_scale, dropout_p=0.0,
                          dropout_seed=0, seqlen_q_real=None, seqlen_k_real=None, leaf_t=None):
    """The split causal schedule (JAX l.1165): one diag launch over the
    T x T leaves, then one merged rect launch per `causal_split_rects(n)`
    entry, in that order. T defaults to `split_leaf_t` at the padded head
    dim; n counts the leaves of the length JAX pads to (`jax_padded_shape`),
    and a rectangle whose rows all lie past the tensors' (JAX's padding
    rows) is left out. The last leaf may be short here."""
    Sq, D, nbytes = q.shape[2], q.shape[3], q.element_size()
    Sq_p, _, Dp = jax_padded_shape(Sq, k.shape[2], D, nbytes)
    T = leaf_t if leaf_t is not None else split_leaf_t(Dp, nbytes)
    n = -(-Sq_p // T)
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed,
              seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    o, lse = flash_attn_forward_causal_diag(q, k, v, lens, q_off, kv_off, T=T, **kw)
    for r0, c0, nr, nc in causal_split_rects(n):
        if r0 * T >= Sq:
            continue
        o, lse = flash_attn_forward_rect(q, k, v, lens, q_off, kv_off, row0=r0 * T, col0=c0 * T,
                                         nrows=nr * T, ncols=nc * T, merge_prev=(o, lse), **kw)
    return o, lse
