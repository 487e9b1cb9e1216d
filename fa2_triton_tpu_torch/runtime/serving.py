"""Continuous-batching serving engine (port of `fa2_triton_tpu.runtime.serving`).

A slot-based scheduler: new requests are prefilled into free KV-cache slots
(same-bucket prompts batched N in {2, 4} per prefill), while ONE batched
decode step advances every slot each iteration. Inactive slots step
harmlessly: their write lands on their own stale row (paged: on the reserved
page 0) and their output is ignored. Greedy decoding; tokens/s metrics.
Prefill runs the `flash_fwd` kernel, decode the `decode` kernel (on CUDA
tensors).

The KV cache is per slot (`runtime/kv_cache.py`) or, with `paged=True`, a
shared page pool (`runtime/paged_cache.py`) of `n_pages` pages of
`page_size` tokens: admission reserves the pages of a prompt's bucket and
waits when the pool is short; a decode step that finds the pool dry
preempts the slot holding the most pages (its tokens so far fold into its
prompt and it re-enters the queue, `Request.folded`); pages behind an
all-layer sliding window go back to the pool; a finished request returns
its pages. `qdtype` (torch.int8 or torch.float8_e4m3fn) stores either cache
quantized.

The host keeps a mirror of every slot's length (`lens_np`), so scheduling
never reads the device; the only per-step device read is the new tokens and
their log-probs.

Not ported yet (each raises NotImplementedError when set): `mesh` (ROADMAP
A.7), `prefill_chunk` and `prefix_cache` (A.1(ii)), and sampling with
temperature > 0 (A.1(ii)).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fa2_triton_tpu_torch.models.llama import (
    LlamaConfig, LlamaModel, decode_step, paged_decode_step, prefill_forward,
)
from fa2_triton_tpu_torch.runtime.kv_cache import KVCacheConfig, init_cache, write_kv
from fa2_triton_tpu_torch.runtime.paged_cache import (
    PagedCacheConfig, PagedKVCache, write_tokens_paged,
)
from fa2_triton_tpu_torch.runtime.sampling import (
    GREEDY, SamplingParams, greedy_tokens_with_logprobs,
)
from fa2_triton_tpu_torch.utils import next_power_of_2, round_up_to_multiple


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    # Raw-model logprob of each generated token, parallel to out_tokens.
    out_logprobs: List[float] = field(default_factory=list)
    done: bool = False
    # Count of out_tokens already folded into `prompt` by preemption
    # (`Engine._preempt`).
    folded: int = 0
    # Per-request stop tokens (checked in addition to the engine eos_id);
    # the stop token is kept in out_tokens.
    stop_ids: Optional[frozenset] = None
    sampling: SamplingParams = GREEDY


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0
    prefill_dispatches: int = 0   # prefill_forward calls (single or batched)
    wall_s: float = 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.wall_s if self.wall_s else 0.0


def _bucket(n: int) -> int:
    """Prompt padding bucket: power of two, at least 64."""
    return max(64, next_power_of_2(n))


class Engine:
    def __init__(
        self,
        params: LlamaModel,
        cfg: LlamaConfig,
        n_slots: int = 8,
        max_seq: int = 2048,
        qdtype: Optional[Any] = None,
        eos_id: Optional[int] = None,
        paged: bool = False,
        n_pages: Optional[int] = None,
        mesh: Optional[Any] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        page_size: Optional[int] = None,
    ):
        for name, value, off, item in (("mesh", mesh, None, "A.7"),
                                       ("prefill_chunk", prefill_chunk, None, "A.1(ii)"),
                                       ("prefix_cache", prefix_cache, False, "A.1(ii)")):
            if value != off:
                raise NotImplementedError(
                    f"Engine({name}=...) is not ported yet; see ROADMAP.md queue A ({item})")
        if params.cfg != cfg:
            raise ValueError("cfg differs from the model's own config")
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.paged = paged
        self.device = params.embed.device
        with torch.inference_mode():
            if paged:
                page = page_size or min(512, round_up_to_multiple(max_seq, 128))
                if page % 128:
                    raise ValueError(f"page_size must be a multiple of 128, got {page}")
                max_seq_p = round_up_to_multiple(max_seq, page)
                self.kv_cfg = PagedCacheConfig(
                    n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    page_size=page,
                    # Default pool: the fully committed equivalent (+1 reserved
                    # page); size it down to overcommit slots against live tokens.
                    n_pages=(n_pages if n_pages is not None
                             else n_slots * (max_seq_p // page) + 1),
                    n_slots=n_slots, max_seq=max_seq_p, qdtype=qdtype, compute_dtype=cfg.dtype,
                )
                self.pcache = PagedKVCache(self.kv_cfg, device=self.device)
                self._max_seq_padded = max_seq_p
            else:
                self.kv_cfg = KVCacheConfig(
                    n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    max_seq=max_seq, n_slots=n_slots, qdtype=qdtype, compute_dtype=cfg.dtype,
                )
                self.caches = init_cache(self.kv_cfg, device=self.device)
                self._max_seq_padded = self.kv_cfg.max_seq_padded
            self.last_tokens = torch.zeros((n_slots,), dtype=torch.long, device=self.device)
        # Pages behind the window are dead only when every layer is windowed.
        self._window = cfg.sliding_window if all(
            cfg.window_for(li) >= 0 for li in range(cfg.n_layers)) else -1
        # Host-side lens mirror: scheduling reads host memory, and the device
        # copy is rebuilt per step (one small H2D copy).
        self.lens_np = np.zeros((n_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.stats = EngineStats()

    # ---------------- device work ----------------------------------------

    def _prefill(self, tokens: np.ndarray, true_len: List[int], slots: List[int]):
        """Prefill N prompts [N, s_pad] in one dispatch, write their k/v into
        the slots' cache rows (the whole padded prompt: per-slot lengths keep
        the padded tail invisible), and pick each next token."""
        tok = torch.from_numpy(tokens).to(self.device)
        tl = torch.tensor(true_len, dtype=torch.int32, device=self.device)
        logits, kvs = prefill_forward(self.params, tok, tl)
        if self.paged:
            # One scatter per layer through the N slots' table rows.
            trows = self.pcache.tables_device()[torch.tensor(slots, device=self.device)]
            zeros = torch.zeros((len(slots),), dtype=torch.int32)
            for pool, (k, v) in zip(self.pcache.pools, kvs):
                write_tokens_paged(pool, trows, k, v, zeros, self.kv_cfg)
        else:
            zero = torch.zeros((1,), dtype=torch.int32)
            for cache, (k, v) in zip(self.caches, kvs):
                for i, slot in enumerate(slots):
                    view = {name: t[slot:slot + 1] for name, t in cache.items()}
                    write_kv(view, k[i:i + 1], v[i:i + 1], zero, self.kv_cfg)
        rows = logits[torch.arange(len(slots), device=self.device), (tl - 1).long()]
        self.stats.prefill_dispatches += 1
        return greedy_tokens_with_logprobs(rows)

    def _decode(self):
        lens = torch.from_numpy(self.lens_np).to(self.device)
        if self.paged:
            logits, _ = paged_decode_step(self.params, self.last_tokens, self.pcache.pools,
                                          self.pcache.tables_device(), lens, self.kv_cfg)
        else:
            logits, self.caches = decode_step(self.params, self.last_tokens, self.caches, lens,
                                              self.kv_cfg)
        return greedy_tokens_with_logprobs(logits)

    # ---------------- scheduling -----------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int,
               sampling: Optional[SamplingParams] = None, stop_ids=None) -> Request:
        sampling = sampling or GREEDY
        if sampling.temperature > 0.0:
            raise NotImplementedError(
                "temperature > 0 sampling is not ported (see ROADMAP.md queue A, A.1(ii))")
        req = Request(rid=len(self.queue), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, sampling=sampling,
                      stop_ids=frozenset(stop_ids) if stop_ids else None)
        self.queue.append(req)
        return req

    def _finish_admission(self, slot: int, req: Request, next_tok: int, next_lp: float):
        self.lens_np[slot] = len(req.prompt)
        self.last_tokens[slot] = next_tok
        req.out_tokens.append(int(next_tok))
        req.out_logprobs.append(float(next_lp))
        self.slot_req[slot] = req
        self._maybe_finish(slot)

    def _admit_batch(self, group):
        """One prefill dispatch for N same-bucket (slot, req) pairs."""
        s_pad = _bucket(len(group[0][1].prompt))
        tokens = np.zeros((len(group), s_pad), np.int64)
        for i, (_, req) in enumerate(group):
            tokens[i, :len(req.prompt)] = req.prompt
        toks, lps = self._prefill(tokens, [len(r.prompt) for _, r in group],
                                  [s for s, _ in group])
        toks_np, lps_np = toks.cpu().numpy(), lps.cpu().numpy()
        for i, (slot, req) in enumerate(group):
            self.stats.prefill_tokens += len(req.prompt)
            self._finish_admission(slot, req, toks_np[i], lps_np[i])

    def _admit(self):
        # Same-bucket admissions are grouped into ONE batched prefill
        # dispatch (N in {2, 4}); odd ones out take the single-slot path.
        batchable: List = []
        for slot, occupant in enumerate(self.slot_req):
            if occupant is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            s_pad = _bucket(len(req.prompt))
            if s_pad > self._max_seq_padded:
                raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds max_seq")
            if self.paged:
                try:
                    self.pcache.ensure_capacity(slot, s_pad)
                except MemoryError:
                    # Wait for pages; the slot keeps none of a partial
                    # reservation (ROADMAP queue C).
                    self.pcache.release(slot)
                    self.queue.insert(0, req)
                    break
            # Reserve the slot now so this loop doesn't re-offer it; the
            # flush below fills in the real state.
            self.slot_req[slot] = req
            batchable.append((slot, req))
        by_bucket: Dict[int, List] = {}
        for slot, req in batchable:
            by_bucket.setdefault(_bucket(len(req.prompt)), []).append((slot, req))
        for group in by_bucket.values():
            while group:
                n = 4 if len(group) >= 4 else (2 if len(group) >= 2 else 1)
                head, group = group[:n], group[n:]
                if n == 1:
                    self._admit_one(*head[0])
                else:
                    self._admit_batch(head)

    def _admit_one(self, slot: int, req: Request):
        """Admit one request into `slot` (a single-prompt prefill)."""
        self._admit_batch([(slot, req)])

    def _maybe_finish(self, slot: int):
        req = self.slot_req[slot]
        if req is None:
            return
        tok = req.out_tokens[-1] if req.out_tokens else None
        exhausted = len(req.out_tokens) >= req.max_new_tokens
        full = int(self.lens_np[slot]) + 1 >= self._max_seq_padded
        stopped = ((self.eos_id is not None and tok == self.eos_id)
                   or (req.stop_ids is not None and tok in req.stop_ids))
        if stopped or exhausted or full:
            req.done = True
            self.slot_req[slot] = None
            if self.paged:
                self.pcache.release(slot)

    def _preempt(self, slot: int):
        """Evict an in-flight request from its slot (paged mode): its pages
        return to the pool, and it re-enters the queue with its generated
        tokens folded into the prompt, so it resumes where it was."""
        req = self.slot_req[slot]
        req.prompt = list(req.prompt) + req.out_tokens[req.folded:]
        req.folded = len(req.out_tokens)
        self.slot_req[slot] = None
        self.pcache.release(slot)
        self.queue.insert(0, req)

    def _make_room(self, active: List[int]):
        """Paged mode, before a decode step: release the pages behind an
        all-layer window (decode never reads them again), then give every
        active slot room for its next token, preempting the slot that holds
        the most pages while the pool is dry."""
        if self._window >= 0:
            page = self.kv_cfg.page_size
            for s in active:
                behind = int(self.lens_np[s]) - self._window
                if behind > 0:
                    self.pcache.release_prefix(s, behind // page)
        for s in active:
            if self.slot_req[s] is None:  # preempted earlier this step
                continue
            while True:
                try:
                    self.pcache.ensure_capacity(s, int(self.lens_np[s]) + 1)
                    break
                except MemoryError:
                    victims = [v for v in active if v != s and self.slot_req[v] is not None]
                    if not victims:
                        raise
                    self._preempt(max(victims, key=lambda x: len(self.pcache._slot_pages[x])))

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: admit waiting requests, then decode all
        active slots by one token."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        if self.paged:
            self._make_room(active)
            active = [s for s in active if self.slot_req[s] is not None]
            if not active:
                return bool(self.queue)
        next_tokens, next_lps = self._decode()
        # The ONLY per-step device read: the new tokens and their logprobs.
        next_np = next_tokens.cpu().numpy()
        lps_np = next_lps.cpu().numpy()
        active_mask = torch.tensor([r is not None for r in self.slot_req], device=self.device)
        self.last_tokens = torch.where(active_mask, next_tokens, self.last_tokens)
        for s in active:
            self.lens_np[s] += 1
        for s in active:
            self.slot_req[s].out_tokens.append(int(next_np[s]))
            self.slot_req[s].out_logprobs.append(float(lps_np[s]))
            self.stats.decode_tokens += 1
            self._maybe_finish(s)
        self.stats.decode_steps += 1
        return True

    def run(self, requests: Optional[List[Request]] = None) -> EngineStats:
        """Drain the queue (plus any given requests) to completion."""
        if requests:
            self.queue.extend(requests)
        t0 = time.perf_counter()
        while self.queue or any(r is not None for r in self.slot_req):
            progressed = self.step()
            if not progressed and not self.queue:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats
