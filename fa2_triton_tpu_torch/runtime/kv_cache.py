"""Per-slot KV cache for serving (port of `fa2_triton_tpu.runtime.kv_cache`).

Caches live in the decode kernel's layout [slots, Hkv, S_max, D] (BHSD, the
sequence padded to 128 as in the JAX package, the head dim unpadded), so a
decode step reads each (slot, head) as one contiguous stripe. Values are
stored in the compute dtype, or quantized (`qdtype` int8 / float8_e4m3fn)
at insert with per-(token, head) fp32 scales laid out [slots, Hkv, 1,
S_max]; the decode kernel folds the scales in. JAX pads D to 128 with zeros,
which leave amax and so the scales unchanged: values and scales here equal
the first D columns of JAX's bit for bit.

Writes update the cache tensors IN PLACE: a functional update would copy the
whole cache (4.3 GB in bf16 at Mistral-7B widths, 8 slots x 4096) per layer
per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from fa2_triton_tpu_torch.ops.quant import QDTYPES, quantize_tensor
from fa2_triton_tpu_torch.utils import resolve_device, round_up_to_multiple


@dataclass(frozen=True)
class KVCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    max_seq: int
    n_slots: int
    qdtype: Optional[Any] = None  # None (compute dtype), torch.int8 or torch.float8_e4m3fn
    compute_dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.qdtype is not None and self.qdtype not in QDTYPES:
            raise ValueError(f"qdtype must be None, torch.int8 or torch.float8_e4m3fn, "
                             f"got {self.qdtype}")

    @property
    def max_seq_padded(self) -> int:
        return round_up_to_multiple(self.max_seq, 128)


def init_cache(cfg: KVCacheConfig, device=None) -> List[dict]:
    """One dict per layer: k, v [slots, Hkv, S_max_padded, D], zero-filled,
    and with `qdtype` k_scale, v_scale [slots, Hkv, 1, S_max_padded] of ones,
    on `device` (default the GPU: `resolve_device`)."""
    device = resolve_device(device)
    shape = (cfg.n_slots, cfg.n_kv_heads, cfg.max_seq_padded, cfg.head_dim)
    sshape = (cfg.n_slots, cfg.n_kv_heads, 1, cfg.max_seq_padded)
    vdtype = cfg.qdtype if cfg.qdtype is not None else cfg.compute_dtype
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"k": torch.zeros(shape, dtype=vdtype, device=device),
                 "v": torch.zeros(shape, dtype=vdtype, device=device)}
        if cfg.qdtype is not None:
            layer["k_scale"] = torch.ones(sshape, dtype=torch.float32, device=device)
            layer["v_scale"] = torch.ones(sshape, dtype=torch.float32, device=device)
        layers.append(layer)
    return layers


def write_kv(
    layer_cache: dict,
    new_k: torch.Tensor,    # [B, S_step, Hkv, D] — B == the cache's slot count
    new_v: torch.Tensor,
    offsets: torch.Tensor,  # [B] int — write position per slot
    cfg: KVCacheConfig,
) -> dict:
    """Write new_k/new_v at per-slot offsets (quantizing if configured), in
    place; returns the dict."""
    B, S = new_k.shape[:2]
    names = ("k", "v")
    vals = [x.to(cfg.compute_dtype).transpose(1, 2) for x in (new_k, new_v)]   # [B, Hkv, S, D]
    scales = None
    if cfg.qdtype is not None:
        vals, scales = zip(*(quantize_tensor(x, cfg.qdtype) for x in vals))    # + [B, Hkv, S, 1]
    dev = layer_cache["k"].device
    if S == 1:
        idx = offsets.to(device=dev, dtype=torch.long)
        rows = torch.arange(B, device=dev)
        for i, name in enumerate(names):
            layer_cache[name][rows, :, idx] = vals[i][:, :, 0]
            if scales is not None:
                layer_cache[name + "_scale"][rows, :, 0, idx] = scales[i][:, :, 0, 0]
    else:
        for b, off in enumerate(offsets.tolist()):
            for i, name in enumerate(names):
                layer_cache[name][b, :, off:off + S] = vals[i][b]
                if scales is not None:
                    layer_cache[name + "_scale"][b, :, 0, off:off + S] = scales[i][b, :, :, 0]
    return layer_cache
