"""Single-step decode attention: the CUDA kernel's wrapper and its plain twin.

Port of `fa2_triton_tpu/ops/decode.py:decode_attention` without the
quantized cache (`_decode_kernel_noquant`, B5), as `csrc/decode.cu`. The
cache keeps the JAX layout [slots, Hkv, S_max, D] without the 128-lane pad.
The int8/fp8 variant (`k_scale` / `v_scale`) is not ported yet and raises.

CPU tensors take `decode_attention_plain`; CUDA tensors always launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fa2_triton_tpu_torch.ops import _build
from fa2_triton_tpu_torch.utils import LOG2E, default_softmax_scale

# Kernel launches since the last reset.
LAUNCHES = 0

HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8)

_c_fn = None


def _entry():
    global _c_fn
    if _c_fn is None:
        lib = _build.load()
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fa2_decode.argtypes = [I] * 6 + [P] * 5 + [I, F, F, P]
        lib.fa2_decode.restype = I
        _c_fn = lib.fa2_decode
    return _c_fn


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    kv_lens: torch.Tensor, *, softmax_scale: Optional[float] = None,
    window_left: int = -1, softcap: float = 0.0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in fp32.
    q [B, Hq, D], caches [B, Hkv, S_max, D], kv_lens [B] -> [B, Hq, D]."""
    B, Hq, D = q.shape
    Hkv, S_max = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else default_softmax_scale(D)
    qf = q.float().view(B, Hkv, g, D)
    s = torch.matmul(qf, k_cache.float().transpose(-1, -2)) * scale   # [B, Hkv, g, S]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    col = torch.arange(S_max, device=q.device).view(1, 1, 1, S_max)
    kv_len = kv_lens.to(device=q.device, dtype=torch.int64).view(B, 1, 1, 1)
    keep = col < kv_len
    if window_left >= 0:
        keep = keep & (col >= kv_len - 1 - window_left)
    s2 = torch.where(keep, s * LOG2E, torch.tensor(float("-inf"), device=q.device))
    m = s2.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    # Masked columns carry p = 0, but a cache row may hold anything: zero it
    # so 0 * NaN cannot reach the output.
    vf = torch.where(keep[:, :, 0, :, None], v_cache.float(), torch.zeros((), device=q.device))
    o = torch.matmul(p, vf) / torch.where(l > 0, l, torch.ones_like(l))
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,                # [B, Hq, D] — one new token per sequence
    k_cache: torch.Tensor,          # [B, Hkv, S_max, D]
    v_cache: torch.Tensor,
    kv_lens: torch.Tensor,          # [B] int32 — valid tokens per sequence
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Returns attention output [B, Hq, D]. `window_left >= 0` attends only
    to the last window_left + 1 positions."""
    global LAUNCHES
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV-cache decode (int8/fp8, B5 quant variant) is not "
            "ported yet; see ROADMAP.md queue A")
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, kv_lens, softmax_scale=softmax_scale,
            window_left=window_left, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode takes CPU or CUDA tensors, got {q.device}")
    B, Hq, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad cache shapes {tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"for q {tuple(q.shape)}")
    Hkv, S_max = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _build.DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode kernel takes one of fp32/fp16/bf16 for q and caches, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if Hq % Hkv != 0 or Hq // Hkv not in GROUPS:
        raise ValueError(f"decode kernel takes Hq / Hkv in {GROUPS}, got {Hq} / {Hkv}")
    if kv_lens.shape != (B,) or kv_lens.dtype != torch.int32:
        raise ValueError("kv_lens must be an int32 [B] tensor")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("kv_lens", kv_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        # Rows are read as vector loads: contiguous, 16-byte aligned base.
        if not t.is_contiguous() or (t is not kv_lens and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous (and q/caches 16-byte aligned)")
    o = torch.empty_like(q)
    if B == 0:
        return o
    scale = softmax_scale if softmax_scale is not None else default_softmax_scale(D)
    status = _entry()(
        _build.DTYPE_CODES[q.dtype], B, Hq, Hkv, S_max, D,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        kv_lens.data_ptr(), int(window_left), float(scale), float(softcap),
        _build.stream_ptr(q.device),
    )
    _build.check(status, "decode launch")
    LAUNCHES += 1
    return o
