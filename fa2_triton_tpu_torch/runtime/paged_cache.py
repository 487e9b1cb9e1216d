"""Paged KV-cache pool with block tables (port of `fa2_triton_tpu.runtime.paged_cache`).

Where `runtime/kv_cache.py` reserves max_seq per slot, the paged pool shares
physical pages among sequences: a slot holds only the pages its live tokens
need, so cache memory scales with live tokens, not slots x max_seq. The
decode side is `ops/decode.py:paged_decode_attention`, which reads each row
through the slot's table and never a page past a slot's length.

Page allocation is host control logic (a free list, per-slot tables and
per-page refcounts, mirrored to a device tensor when they change); token
writes are in-place device scatters of values (and, with `qdtype`, of their
scales). The head dim is zero-padded to the kernels' width
(`head_dim_padded`, `ops/attention.py:kernel_head_dim`; JAX pads it to 128
lanes), and zeros leave the scales unchanged, so pools, scales and
allocator state equal JAX's, first head_dim columns, bit for bit.

Automatic prefix caching: full pages are content-addressed by a chain hash
over their token ids (`_chunk_hash`, blake2b) and shared by refcount. A
shared page is never written, because a slot writes only at positions past
its attached prefix. A registered page whose last reference goes stays
resident on an LRU (`_cached_free`, counted in `free_pages`) until the
allocator needs it, so a later request with the same prompt prefix attaches
it (`match_prefix`, `attach`) instead of recomputing its k/v.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fa2_triton_tpu_torch.ops.attention import kernel_head_dim, pad_last
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
    def head_dim_padded(self) -> int:
        return kernel_head_dim(self.head_dim)

    @property
    def max_pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)


class PagedKVCache:
    """Shared page pool + per-slot block tables + free-list allocator."""

    def __init__(self, cfg: PagedCacheConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (cfg.n_pages, cfg.n_kv_heads, cfg.page_size, cfg.head_dim_padded)
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
        # Prefix-cache state: per-page refcounts; chain hash -> page of each
        # registered full page and back; the LRU of ref-0 registered pages,
        # whose contents are still valid.
        self._refs = np.zeros((cfg.n_pages,), np.int32)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()

    # ------------------------- host allocation ---------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._cached_free)

    def tables_device(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables.copy()).to(self.device)
        return self._tables_dev

    def _alloc_page(self) -> int:
        if self._free:
            return self._free.pop()
        # Evict the least recently released registered page: nothing
        # references it, so it can be repurposed.
        if self._cached_free:
            page, _ = self._cached_free.popitem(last=False)
            del self._hash_to_page[self._page_hash.pop(page)]
            return page
        raise MemoryError("KV page pool exhausted")

    def _unref(self, page: int) -> None:
        """Drop one reference: a page nobody references returns to the free
        list, or to the LRU if it is registered."""
        self._refs[page] -= 1
        if self._refs[page] == 0:
            if page in self._page_hash:
                self._cached_free[page] = None
            else:
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
        """Drop the slot's references (`_unref` of each page, last first)."""
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

    # ------------------------- prefix caching ----------------------------

    @staticmethod
    def _chunk_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
        return hashlib.blake2b(prev + np.asarray(tokens, np.int32).tobytes(),
                               digest_size=16).digest()

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest registered full-page prefix of `tokens` -> (n_tokens,
        pages). Capped at len(tokens) - 1 tokens, so that at least one token
        is left to prefill (its logits pick the first generated token)."""
        P = self.cfg.page_size
        pages: List[int] = []
        h = b""
        for i in range((len(tokens) - 1) // P):
            h = self._chunk_hash(h, tokens[i * P:(i + 1) * P])
            page = self._hash_to_page.get(h)
            if page is None:
                break
            pages.append(page)
        return len(pages) * P, pages

    def attach(self, slot: int, pages: Sequence[int]) -> None:
        """Point an empty slot's table at shared prefix pages (one reference
        each; a page on the LRU leaves it). The slot must write only at
        positions >= len(pages) * page_size."""
        if self._slot_pages[slot] or self._slot_freed[slot]:
            raise ValueError(f"attach needs an empty slot; slot {slot} holds pages")
        for i, page in enumerate(pages):
            self._tables[slot, i] = page
            self._refs[page] += 1
            self._cached_free.pop(page, None)
        self._slot_pages[slot] = list(pages)
        self._tables_dev = None

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> None:
        """Publish the slot's full pages, which hold the k/v of `tokens`
        from position 0, into the prefix cache (the first page registered
        under a hash keeps it). Pages released behind a window are hashed
        past but not published."""
        P = self.cfg.page_size
        freed = self._slot_freed[slot]
        h = b""
        for i in range(len(tokens) // P):
            h = self._chunk_hash(h, tokens[i * P:(i + 1) * P])
            if i < freed:
                continue
            page = self._slot_pages[slot][i - freed]
            if h not in self._hash_to_page and page not in self._page_hash:
                self._hash_to_page[h] = page
                self._page_hash[page] = h

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
    place (quantizing if configured), zero-padded to the pool's head dim
    (JAX l.259); returns the pool dict. Token (b, i) lands at page
    tables[b, (positions[b] + i) // page_size], row (positions[b] + i) %
    page_size."""
    B, S_step, Hkv = new_k.shape[:3]
    D = cfg.head_dim_padded
    dev = pool["k"].device
    pos = positions.to(device=dev, dtype=torch.long)[:, None] + torch.arange(S_step, device=dev)
    pages = torch.gather(tables.to(dev).long(), 1, pos // cfg.page_size).reshape(-1)   # [B * S]
    offs = (pos % cfg.page_size).reshape(-1)
    for name, x in (("k", new_k), ("v", new_v)):
        tok = pad_last(x.to(cfg.compute_dtype), D).reshape(B * S_step, Hkv, D)   # [N, Hkv, D]
        if cfg.qdtype is not None:
            tok, scale = quantize_tensor(tok, cfg.qdtype)           # + [N, Hkv, 1]
            # The two index tensors are split by a slice, so the indexed
            # dims come first: the target is [N, Hkv].
            pool[name + "_scale"][pages, :, 0, offs] = scale[..., 0]
        pool[name][pages, :, offs, :] = tok
    return pool
