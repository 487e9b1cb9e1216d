"""KV-cache and weight-only quantization (port of `fa2_triton_tpu.ops.quant`).

KV cache: values are stored int8 or float8_e4m3fn with per-(token, head)
symmetric scales, amax over the head dim, and the decode kernels fold the
scales into the attention math (`ops/decode.py`). Values and scales are
bitwise equal to the JAX package's for fp32 inputs: the same fp32 amax,
division, round-half-to-even and clip, and fp8 by a plain cast.

A quantized weight is a dict {"qvalues": int8 or float8_e4m3fn [in, out],
"qscale": fp32 [1, out]} with per-output-channel scales, so the dequant
folds into the matmul epilogue: x @ (wq * s) == (x @ wq) * s.
"""
from __future__ import annotations

from typing import Tuple

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn
QDTYPES = (torch.int8, torch.float8_e4m3fn)


def _quantize(xf: torch.Tensor, dim: int, qdtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 `xf` -> (values, fp32 scales) with amax over `dim` (kept)."""
    if qdtype not in QDTYPES:
        raise ValueError(f"qdtype must be torch.int8 or torch.float8_e4m3fn, got {qdtype}")
    amax = xf.abs().amax(dim=dim, keepdim=True)
    qmax = INT8_MAX if qdtype == torch.int8 else FP8_MAX
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = xf / scale
    if qdtype == torch.int8:
        vals = torch.clamp(torch.round(scaled), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        vals = scaled.to(qdtype)
    return vals, scale


def quantize_tensor(x: torch.Tensor, qdtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize [..., D] to qdtype with per-[...] (amax over D) scales.
    Returns (values [..., D] qdtype, scales [..., 1] fp32) with
    x ~= values * scales."""
    return _quantize(x.float(), -1, qdtype)


def dequantize_tensor(vals: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (vals.float() * scales).to(dtype)


def quantize_kv(k: torch.Tensor, v: torch.Tensor, qdtype=torch.int8):
    """Quantize K/V [B, S, H, D] -> ((kq, ks), (vq, vs))."""
    return quantize_tensor(k, qdtype), quantize_tensor(v, qdtype)


def quantize_weight(w: torch.Tensor, qdtype=torch.int8) -> dict:
    """[in, out] -> {"qvalues", "qscale"} with per-output-channel scales."""
    vals, scale = _quantize(w.float(), 0, qdtype)
    return {"qvalues": vals, "qscale": scale}


def is_quantized_weight(w) -> bool:
    return isinstance(w, dict) and "qvalues" in w


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain or weight-only-quantized w (dequant in the epilogue)."""
    if is_quantized_weight(w):
        y = torch.matmul(x.float(), w["qvalues"].to(x.dtype).float())
        return (y * w["qscale"]).to(x.dtype)
    return x @ w
