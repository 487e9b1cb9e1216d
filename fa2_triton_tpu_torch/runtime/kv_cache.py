"""Per-slot KV cache for serving (port of `fa2_triton_tpu.runtime.kv_cache`).

Caches live in the decode kernel's layout [slots, Hkv, S_max, D] (BHSD, the
sequence padded to 128 as in the JAX package, the head dim unpadded), so a
decode step reads each (slot, head) as one contiguous stripe. Writes update
the cache tensors IN PLACE: a functional update would copy the whole cache
(4.3 GB at Mistral-7B widths, 8 slots x 4096) per layer per step.

Quantized storage (`qdtype`) waits for the quantized decode kernel and raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from fa2_triton_tpu_torch.utils import round_up_to_multiple


@dataclass(frozen=True)
class KVCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    max_seq: int
    n_slots: int
    qdtype: Optional[Any] = None  # None only; int8/fp8 storage is not ported
    compute_dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.qdtype is not None:
            raise NotImplementedError(
                "quantized KV cache (int8/fp8) is not ported yet; see ROADMAP.md queue A")

    @property
    def max_seq_padded(self) -> int:
        return round_up_to_multiple(self.max_seq, 128)


def init_cache(cfg: KVCacheConfig, device=None) -> List[dict]:
    """One dict per layer: k, v [slots, Hkv, S_max_padded, D], zero-filled."""
    shape = (cfg.n_slots, cfg.n_kv_heads, cfg.max_seq_padded, cfg.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
         "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
        for _ in range(cfg.n_layers)
    ]


def write_kv(
    layer_cache: dict,
    new_k: torch.Tensor,    # [B, S_step, Hkv, D] — B == the cache's slot count
    new_v: torch.Tensor,
    offsets: torch.Tensor,  # [B] int — write position per slot
    cfg: KVCacheConfig,
) -> dict:
    """Write new_k/new_v at per-slot offsets, in place; returns the dict."""
    k, v = layer_cache["k"], layer_cache["v"]
    B, S = new_k.shape[:2]
    kT = new_k.to(cfg.compute_dtype).transpose(1, 2)   # [B, Hkv, S, D]
    vT = new_v.to(cfg.compute_dtype).transpose(1, 2)
    if S == 1:
        idx = offsets.to(device=k.device, dtype=torch.long)
        rows = torch.arange(B, device=k.device)
        k[rows, :, idx] = kT[:, :, 0]
        v[rows, :, idx] = vT[:, :, 0]
    else:
        for b, off in enumerate(offsets.tolist()):
            k[b, :, off:off + S] = kT[b]
            v[b, :, off:off + S] = vT[b]
    return layer_cache
