"""Weight-only quantization and `qmatmul` (port of `fa2_triton_tpu.ops.quant`).

A quantized weight is a dict {"qvalues": int8 or float8_e4m3fn [in, out],
"qscale": fp32 [1, out]} with per-output-channel scales, so the dequant
folds into the matmul epilogue: x @ (wq * s) == (x @ wq) * s. The KV-cache
quantizers of the JAX module wait for the quantized decode kernel.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn


def quantize_weight(w: torch.Tensor, qdtype=torch.int8) -> dict:
    """[in, out] -> {"qvalues", "qscale"} with per-output-channel scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)               # [1, out]
    qmax = INT8_MAX if qdtype == torch.int8 else FP8_MAX
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = wf / scale
    if qdtype == torch.int8:
        vals = torch.clamp(torch.round(scaled), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        vals = scaled.to(qdtype)
    return {"qvalues": vals, "qscale": scale}


def is_quantized_weight(w) -> bool:
    return isinstance(w, dict) and "qvalues" in w


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain or weight-only-quantized w (dequant in the epilogue)."""
    if is_quantized_weight(w):
        y = torch.matmul(x.float(), w["qvalues"].to(x.dtype).float())
        return (y * w["qscale"]).to(x.dtype)
    return x @ w
