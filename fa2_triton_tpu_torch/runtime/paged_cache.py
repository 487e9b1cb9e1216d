"""Paged KV-cache pool with block tables (port of `fa2_triton_tpu.runtime.paged_cache`).

Where `runtime/kv_cache.py` reserves max_seq per slot, the paged pool shares
physical pages among sequences: a slot holds only the pages its live tokens
need, so cache memory scales with live tokens, not slots x max_seq. The
decode side is `ops/decode.py:paged_decode_attention`, which reads each row
through the slot's table and never a page past a slot's length.

Page allocation is host control logic (a free list, per-slot tables and
per-page refcounts, mirrored to a device tensor when they change); token
writes are in-place device scatters of values (and, with `qdtype`, of their
scales). The head dim is not padded (JAX pads it to 128 with zeros, which
leave the scales unchanged), so pools, scales and allocator state equal
JAX's, first D columns, bit for bit.

Not ported yet (ROADMAP A.1(ii)): the prefix cache — `match_prefix`,
`attach`, `register_prefix` and the LRU of released registered pages. The
refcounts are kept so that it slots in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from fa2_triton_tpu_torch.ops.quant import QDTYPES, quantize_tensor
from fa2_triton_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class PagedCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 512            # tokens per page (a multiple of 128)
    n_pages: int = 64               # physical pages in the shared pool, page 0 reserved
    n_slots: int = 8
    max_seq: int = 8192
    qdtype: Optional[Any] = None    # None (compute dtype), torch.int8 or torch.float8_e4m3fn
    compute_dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.qdtype is not None and self.qdtype not in QDTYPES:
            raise ValueError(f"qdtype must be None, torch.int8 or torch.float8_e4m3fn, "
                             f"got {self.qdtype}")

    @property
    def max_pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)


class PagedKVCache:
    """Shared page pool + per-slot block tables + free-list allocator."""

    def __init__(self, cfg: PagedCacheConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (cfg.n_pages, cfg.n_kv_heads, cfg.page_size, cfg.head_dim)
        sshape = (cfg.n_pages, cfg.n_kv_heads, 1, cfg.page_size)
        vdtype = cfg.qdtype if cfg.qdtype is not None else cfg.compute_dtype
        self.pools: List[dict] = []
        for _ in range(cfg.n_layers):
            layer = {"k": torch.zeros(shape, dtype=vdtype, device=self.device),
                     "v": torch.zeros(shape, dtype=vdtype, device=self.device)}
            if cfg.qdtype is not None:
                layer["k_scale"] = torch.ones(sshape, dtype=torch.float32, device=self.device)
                layer["v_scale"] = torch.ones(sshape, dtype=torch.float32, device=self.device)
            self.pools.append(layer)
        # Host-side control state. Page 0 is reserved as the target of
        # unallocated table entries (never handed out).
        self._free: List[int] = list(range(cfg.n_pages - 1, 0, -1))
        self._tables = np.zeros((cfg.n_slots, cfg.max_pages_per_slot), np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(cfg.n_slots)]
        # Leading logical pages already released behind a sliding window
        # (`release_prefix`): logical page i >= _slot_freed[slot] lives at
        # _slot_pages[i - _slot_freed[slot]].
        self._slot_freed: List[int] = [0] * cfg.n_slots
        self._tables_dev: Optional[torch.Tensor] = None
        self._refs = np.zeros((cfg.n_pages,), np.int32)

    # ------------------------- host allocation ---------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def tables_device(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables.copy()).to(self.device)
        return self._tables_dev

    def _alloc_page(self) -> int:
        if self._free:
            return self._free.pop()
        raise MemoryError("KV page pool exhausted")

    def _unref(self, page: int) -> None:
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Allocate pages so `slot` can hold n_tokens; raises MemoryError if
        the pool is exhausted (the pages allocated so far stay)."""
        need = -(-n_tokens // self.cfg.page_size)
        if need > self.cfg.max_pages_per_slot:
            raise ValueError(f"{n_tokens} tokens exceed max_seq {self.cfg.max_seq}")
        pages = self._slot_pages[slot]
        freed = self._slot_freed[slot]
        while freed + len(pages) < need:
            page = self._alloc_page()
            self._refs[page] = 1
            self._tables[slot, freed + len(pages)] = page
            pages.append(page)
            self._tables_dev = None

    def release(self, slot: int) -> None:
        """Drop the slot's references; pages nobody references return to
        the free list."""
        for page in reversed(self._slot_pages[slot]):
            self._unref(page)
        self._slot_pages[slot] = []
        self._slot_freed[slot] = 0
        self._tables[slot] = 0
        self._tables_dev = None

    def release_prefix(self, slot: int, n_logical_pages: int) -> None:
        """Release the slot's leading logical pages (sliding-window serving:
        pages entirely behind the window are never read again, since decode
        starts at the window), so their memory returns to the pool while the
        sequence keeps generating. Their table entries point at the reserved
        page 0 afterwards."""
        freed = self._slot_freed[slot]
        drop = n_logical_pages - freed
        if drop <= 0:
            return
        if drop > len(self._slot_pages[slot]):
            raise ValueError(f"slot {slot} holds {len(self._slot_pages[slot])} live pages, "
                             f"cannot release {drop}")
        for i, page in enumerate(self._slot_pages[slot][:drop]):
            self._unref(page)
            self._tables[slot, freed + i] = 0
        self._slot_pages[slot] = self._slot_pages[slot][drop:]
        self._slot_freed[slot] = n_logical_pages
        self._tables_dev = None

    # ------------------------- device writes -----------------------------

    def write_tokens(
        self,
        layer_idx: int,
        new_k: torch.Tensor,      # [B, S_step, Hkv, D] — B == n_slots
        new_v: torch.Tensor,
        positions: torch.Tensor,  # [B] int — first token's seq position per slot
    ) -> None:
        """Scatter S_step new tokens per slot into the shared pool, in place.
        Callers must have `ensure_capacity(slot, position + S_step)` first."""
        write_tokens_paged(self.pools[layer_idx], self.tables_device(), new_k, new_v,
                           positions, self.cfg)

    # ------------------------- decode read -------------------------------

    def attention(self, layer_idx: int, q: torch.Tensor, kv_lens: torch.Tensor,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
        """Paged decode attention for one layer; q [B, Hq, D]."""
        from fa2_triton_tpu_torch.ops.decode import paged_decode_attention

        pool = self.pools[layer_idx]
        return paged_decode_attention(
            q, pool["k"], pool["v"], self.tables_device(), kv_lens,
            pool.get("k_scale"), pool.get("v_scale"), softmax_scale=softmax_scale)


def write_tokens_paged(
    pool: dict,
    tables: torch.Tensor,     # [n_slots, max_pages] int32
    new_k: torch.Tensor,      # [B, S_step, Hkv, D] — B == the tables' rows
    new_v: torch.Tensor,
    positions: torch.Tensor,  # [B] int — first token's seq position per slot
    cfg: PagedCacheConfig,
) -> dict:
    """Scatter S_step new tokens per slot into the shared page pool, in
    place (quantizing if configured); returns the pool dict. Token (b, i)
    lands at page tables[b, (positions[b] + i) // page_size], row
    (positions[b] + i) % page_size."""
    B, S_step, Hkv, D = new_k.shape
    dev = pool["k"].device
    pos = positions.to(device=dev, dtype=torch.long)[:, None] + torch.arange(S_step, device=dev)
    pages = torch.gather(tables.to(dev).long(), 1, pos // cfg.page_size).reshape(-1)   # [B * S]
    offs = (pos % cfg.page_size).reshape(-1)
    for name, x in (("k", new_k), ("v", new_v)):
        tok = x.to(cfg.compute_dtype).reshape(B * S_step, Hkv, D)   # token-major [N, Hkv, D]
        if cfg.qdtype is not None:
            tok, scale = quantize_tensor(tok, cfg.qdtype)           # + [N, Hkv, 1]
            # The two index tensors are split by a slice, so the indexed
            # dims come first: the target is [N, Hkv].
            pool[name + "_scale"][pages, :, 0, offs] = scale[..., 0]
        pool[name][pages, :, offs, :] = tok
    return pool
