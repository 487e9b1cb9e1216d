"""FlashAttention-2 forward: the CUDA kernel's wrapper and its plain twin.

Port of `fa2_triton_tpu/ops/flash_fwd.py:flash_attn_forward` as the serving
prefill and the training forward reach it: the TPU's `_fwd_kernel` (B1, with
its additive bias) and `_fwd_tri_square_kernel` (B9) both become
`csrc/flash_fwd.cu`. Tensors are
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

CPU tensors take `flash_attn_forward_plain`; CUDA tensors always launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops import _build
from fa2_triton_tpu_torch.utils import LOG2E, dropout_keep_mask, dropout_threshold

# Kernel launches since the last reset (the smoke test reads this to show the
# served path went through the kernel).
LAUNCHES = 0

HEAD_DIMS = (64, 128, 256)
# The attention entry points zero-pad other head dims up to the next of
# HEAD_DIMS; past the last, the dq and dk/dv tiles need more shared memory
# than a Hopper block has (ROADMAP.md queue C, "Head dims").
MAX_HEAD_DIM = HEAD_DIMS[-1]

_c_fn = None


def _entry():
    global _c_fn
    if _c_fn is None:
        fn = _build.load().fa2_flash_fwd
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        U = ctypes.c_uint
        fn.argtypes = ([I] * 7 + [P] * 6 + [L] * 12 + [P, I] + [L] * 4 + [I] * 5 + [F, F]
                       + [I, U, U, F, I, I, P])
        fn.restype = I
        _c_fn = fn
    return _c_fn


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


def _check_cuda_args(q, k, v, lens=None):
    """Raise on BHSD q / k / v (and [B, 2] lens, when given) that the
    attention kernels do not take."""
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
        # 4-element vector loads: last dim contiguous, the other strides and
        # the base address aligned.
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous, strides a multiple "
                             f"of 4 elements and the base 16-byte aligned; got strides {t.stride()}")


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
    seqlen_q_real: Optional[int] = None,   # dropout counter lengths (default: Sq, Sk)
    seqlen_k_real: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o [B, Hq, Sq, D] in q's dtype, lse [B, Hq, Sq] fp32, log2).

    `o` is a BHSD view of BSHD-contiguous memory, so `o.transpose(1, 2)` is
    the contiguous BSHD output."""
    global LAUNCHES
    drop = dropout_c_args(dropout_p, dropout_seed)
    if q.device.type == "cpu":
        return flash_attn_forward_plain(
            q, k, v, lens, q_off, kv_off, bias, causal=causal,
            softmax_scale=softmax_scale, window=window, softcap=softcap, dropout_p=dropout_p,
            dropout_seed=dropout_seed, seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd takes CPU or CUDA tensors, got {q.device}")
    _check_cuda_args(q, k, v, lens)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    bv = bias_view(bias, q, Sk) if bias is not None else None
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
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
        int(seqlen_q_real or Sq), int(seqlen_k_real or Sk), _build.stream_ptr(q.device),
    )
    _build.check(status, "flash_fwd launch")
    LAUNCHES += 1
    return o, lse
