"""Continuous-batching serving engine (port of `fa2_triton_tpu.runtime.serving`).

A slot-based scheduler: new requests are prefilled into free KV-cache slots
(same-bucket prompts batched N in {2, 4} per prefill), while ONE batched
decode step advances every slot each iteration. Inactive slots step
harmlessly: their write lands on their own stale row (paged: on the reserved
page 0) and their output is ignored. Prefill runs the `flash_fwd` kernel,
decode the `decode` kernel (on CUDA tensors).

The KV cache is per slot (`runtime/kv_cache.py`) or, with `paged=True`, a
shared page pool (`runtime/paged_cache.py`) of `n_pages` pages of
`page_size` tokens: admission reserves the pages of a prompt's bucket and
waits when the pool is short; a decode step that finds the pool dry
preempts the slot holding the most pages (its tokens so far fold into its
prompt and it re-enters the queue, `Request.folded`); pages behind an
all-layer sliding window go back to the pool; a finished request returns
its pages. `qdtype` (torch.int8 or torch.float8_e4m3fn) stores either cache
quantized.

`prefill_chunk` (a multiple of 128): a longer prompt claims its slot at
once and is prefilled one chunk of that many tokens per engine step
(`models/llama.py:chunk_prefill_step`), interleaved with the batched decode,
so it does not stall the slots already generating. `prefix_cache=True`
(paged only): finished and prefilled prompts leave their full pages
registered by content, and a request whose prompt starts with registered
pages attaches them and prefills only the rest (a suffix prefill, the same
chunk step over the cached prefix), one admission at a time. Requests take
`SamplingParams` (temperature / top-k / top-p / seed, `runtime/sampling.py`,
JAX's threefry stream); a decode step whose live slots are all greedy runs
no sampling op.

The host keeps a mirror of every slot's length (`lens_np`) and sampling
parameters, so scheduling never reads the device; the only per-step device
read is the new tokens and their log-probs.

`mesh` (a `parallel/mesh.py:make_mesh` DeviceMesh with only a `model`
axis above 1) serves tensor-parallel, one rank a head shard (JAX
l.110-229): every rank builds the Engine on the same full model and keeps
its piece (`shard_params` with `serving_param_pspecs`: heads and MLP
hidden cut, lm_head replicated), its caches hold its kv heads (int8 / fp8
scales with them), and the row-parallel products are summed over the
model group (`models/llama.py`'s `tp_group`), so every rank computes the
same replicated logits. The host scheduler runs the same on every rank and
so agrees on tokens, sampling streams, pages and the prefix cache.
`DataParallelEngine` (JAX l.934-1011) serves one TP replica per `data`
slice from a shared queue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fa2_triton_tpu_torch.models.llama import (
    LlamaConfig, LlamaModel, chunk_prefill_step, decode_step, paged_chunk_prefill_step,
    paged_decode_step, prefill_forward,
)
from fa2_triton_tpu_torch.parallel.collectives import all_gather_ints
from fa2_triton_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, axis_group, axis_rank, axis_size, axis_sizes, serving_param_pspecs,
    shard_params,
)
from fa2_triton_tpu_torch.runtime.kv_cache import KVCacheConfig, init_cache, write_kv
from fa2_triton_tpu_torch.runtime.paged_cache import (
    PagedCacheConfig, PagedKVCache, write_tokens_paged,
)
from fa2_triton_tpu_torch.runtime.sampling import (
    GREEDY, SamplingParams, greedy_tokens_with_logprobs, sample_tokens_with_logprobs,
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
    # Token i is drawn from fold_in(PRNGKey(seed), i), so a rerun or a
    # preempted request's resume reproduces it.
    sampling: SamplingParams = GREEDY


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0
    # Prefill dispatches: prefill_forward calls (single or batched), prompt
    # chunks and prefix-hit suffixes; each runs flash_fwd once per layer.
    prefill_dispatches: int = 0
    # Prompt tokens whose k/v came from the prefix cache (never recomputed).
    prefix_cached_tokens: int = 0
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
        if params.cfg != cfg:
            raise ValueError("cfg differs from the model's own config")
        # Tensor parallelism over the mesh's `model` axis: this rank keeps
        # its head shard of the weights and caches.
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (parallel/mesh.py:make_mesh), got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.tp = axis_size(mesh, AXIS_MODEL)
        self.tp_group = None
        if mesh is not None:
            extra = {a: n for a, n in axis_sizes(mesh).items() if a != AXIS_MODEL and n > 1}
            if extra:
                raise ValueError(f"a serving mesh has only the model axis, got {extra}")
            if self.tp > 1:
                params = shard_params(params, mesh, serving_param_pspecs(params))
                self.tp_group = axis_group(mesh, AXIS_MODEL)
        self.cfg_local = params.cfg
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True")
        if prefill_chunk is not None and (prefill_chunk <= 0 or prefill_chunk % 128):
            raise ValueError(f"prefill_chunk must be a positive multiple of 128, "
                             f"got {prefill_chunk}")
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.paged = paged
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        self.device = params.embed.device
        with torch.inference_mode():
            if paged:
                page = page_size or min(512, round_up_to_multiple(max_seq, 128))
                if page % 128:
                    raise ValueError(f"page_size must be a multiple of 128, got {page}")
                max_seq_p = round_up_to_multiple(max_seq, page)
                self.kv_cfg = PagedCacheConfig(
                    n_layers=cfg.n_layers, n_kv_heads=self.cfg_local.n_kv_heads, head_dim=cfg.hd,
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
                    n_layers=cfg.n_layers, n_kv_heads=self.cfg_local.n_kv_heads, head_dim=cfg.hd,
                    max_seq=max_seq, n_slots=n_slots, qdtype=qdtype, compute_dtype=cfg.dtype,
                )
                self.caches = init_cache(self.kv_cfg, device=self.device)
                self._max_seq_padded = self.kv_cfg.max_seq_padded
            self.last_tokens = torch.zeros((n_slots,), dtype=torch.long, device=self.device)
        # Pages behind the window are dead only when every layer is windowed.
        self._window = cfg.sliding_window if all(
            cfg.window_for(li) >= 0 for li in range(cfg.n_layers)) else -1
        # Host-side mirrors: scheduling reads host memory, and the device
        # copies are rebuilt per step (small H2D copies). Sampling
        # parameters stay with a slot after its request ends; only live
        # slots decide whether a step samples.
        self.lens_np = np.zeros((n_slots,), np.int32)
        self.temp_np = np.zeros((n_slots,), np.float32)
        self.topk_np = np.zeros((n_slots,), np.int32)
        self.topp_np = np.ones((n_slots,), np.float32)
        self.seed_np = np.zeros((n_slots,), np.int64)   # uint32 values
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        # Slots whose prompt is mid-prefill -> the next prompt offset.
        self._prefilling: Dict[int, int] = {}
        self.stats = EngineStats()

    # ---------------- token choice ---------------------------------------

    @staticmethod
    def _samp(reqs: List[Request]):
        """Sampling arguments of one row per request; each row's step is
        the number of tokens its request has generated (nonzero when a
        preempted request re-prefills its partial generation)."""
        return (np.array([r.sampling.temperature for r in reqs], np.float32),
                np.array([r.sampling.top_k for r in reqs], np.int64),
                np.array([r.sampling.top_p for r in reqs], np.float32),
                np.array([r.sampling.seed & 0xFFFFFFFF for r in reqs], np.int64),
                np.array([len(r.out_tokens) for r in reqs], np.int64))

    def _samp_batch(self):
        """Per-slot sampling arguments of the batched decode step."""
        steps = np.array([len(r.out_tokens) if r is not None else 0 for r in self.slot_req],
                         np.int64)
        return self.temp_np, self.topk_np, self.topp_np, self.seed_np, steps

    def _set_slot_sampling(self, slot: int, req: Request):
        sp = req.sampling
        self.temp_np[slot] = sp.temperature
        self.topk_np[slot] = sp.top_k
        self.topp_np[slot] = sp.top_p
        self.seed_np[slot] = sp.seed & 0xFFFFFFFF

    @staticmethod
    def _select(logits: torch.Tensor, samp, greedy: bool):
        """Tokens and raw-model log-probs of logits [N, V]: argmax when
        every row that counts is greedy (no sort, no random bits), else the
        sampler on every row."""
        if greedy:
            return greedy_tokens_with_logprobs(logits)
        return sample_tokens_with_logprobs(logits, *samp)

    # ---------------- device work ----------------------------------------

    def _prefill(self, tokens: np.ndarray, group):
        """Prefill N prompts [N, s_pad] in one dispatch into the slots of
        `group` ((slot, req) pairs), write their k/v into the slots' cache
        rows (the whole padded prompt: per-slot lengths keep the padded tail
        invisible), and pick each next token."""
        slots = [s for s, _ in group]
        reqs = [r for _, r in group]
        tok = torch.from_numpy(tokens).to(self.device)
        tl = torch.tensor([len(r.prompt) for r in reqs], dtype=torch.int32, device=self.device)
        logits, kvs = prefill_forward(self.params, tok, tl, self.tp_group)
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
        return self._select(rows, self._samp(reqs),
                            all(r.sampling.temperature <= 0.0 for r in reqs))

    def _chunk(self, slot: int, req: Request, chunk: List[int], width: int, cache_len: int):
        """One chunk or prompt-suffix prefill of `slot`: `chunk`'s tokens,
        right-padded to `width`, go in at `cache_len` over the slot's cached
        rows. Returns the next token and its log-prob (host values)."""
        tokens = np.zeros((1, width), np.int64)
        tokens[0, :len(chunk)] = chunk
        tok = torch.from_numpy(tokens).to(self.device)
        if self.paged:
            logits = paged_chunk_prefill_step(self.params, tok, len(chunk), cache_len,
                                              self.pcache.pools, self.pcache.tables_device(),
                                              slot, self.kv_cfg, self.tp_group)
        else:
            logits = chunk_prefill_step(self.params, tok, len(chunk), cache_len, self.caches,
                                        self.kv_cfg, slot, self.tp_group)
        self.stats.prefill_dispatches += 1
        toks, lps = self._select(logits, self._samp([req]), req.sampling.temperature <= 0.0)
        return int(toks[0]), float(lps[0])

    def _decode(self, active: List[int]):
        """The batched decode step over every slot, then each slot's token:
        by argmax when every live slot in `active` is greedy."""
        lens = torch.from_numpy(self.lens_np).to(self.device)
        if self.paged:
            logits, _ = paged_decode_step(self.params, self.last_tokens, self.pcache.pools,
                                          self.pcache.tables_device(), lens, self.kv_cfg,
                                          self.tp_group)
        else:
            logits, self.caches = decode_step(self.params, self.last_tokens, self.caches, lens,
                                              self.kv_cfg, self.tp_group)
        return self._select(logits, self._samp_batch(),
                            all(self.temp_np[s] <= 0.0 for s in active))

    # ---------------- scheduling -----------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int,
               sampling: Optional[SamplingParams] = None, stop_ids=None) -> Request:
        req = Request(rid=len(self.queue), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, sampling=sampling or GREEDY,
                      stop_ids=frozenset(stop_ids) if stop_ids else None)
        self.queue.append(req)
        return req

    def _finish_admission(self, slot: int, req: Request, next_tok: int, next_lp: float):
        """The prompt's k/v are all in: publish its full pages (prefix
        cache), and the slot starts decoding from its first token."""
        if self.prefix_cache:
            self.pcache.register_prefix(slot, req.prompt)
        self.lens_np[slot] = len(req.prompt)
        self.last_tokens[slot] = int(next_tok)
        req.out_tokens.append(int(next_tok))
        req.out_logprobs.append(float(next_lp))
        self.slot_req[slot] = req
        self._set_slot_sampling(slot, req)
        self._maybe_finish(slot)

    def _chunked(self, req: Request) -> bool:
        return self.prefill_chunk is not None and len(req.prompt) > self.prefill_chunk

    def _reserve(self, slot: int, req: Request, n_tokens: int) -> bool:
        """Pages for `n_tokens` rows of `slot`, or, when the pool is short,
        none at all (the slot releases what it took; ROADMAP queue C) and
        the request goes back to the head of the queue."""
        try:
            self.pcache.ensure_capacity(slot, n_tokens)
            return True
        except MemoryError:
            self.pcache.release(slot)
            self.queue.insert(0, req)
            return False

    def _admit_batch(self, group):
        """One prefill dispatch for N same-bucket (slot, req) pairs."""
        s_pad = _bucket(len(group[0][1].prompt))
        tokens = np.zeros((len(group), s_pad), np.int64)
        for i, (_, req) in enumerate(group):
            tokens[i, :len(req.prompt)] = req.prompt
        toks, lps = self._prefill(tokens, group)
        toks_np, lps_np = toks.cpu().numpy(), lps.cpu().numpy()
        for i, (slot, req) in enumerate(group):
            self.stats.prefill_tokens += len(req.prompt)
            self._finish_admission(slot, req, toks_np[i], lps_np[i])

    def _admit(self):
        """Fill free slots from the queue. Same-bucket prompts are grouped
        into ONE batched prefill dispatch (N in {2, 4}); chunked prompts,
        prefix-cache admissions and odd ones out take `_admit_one`.
        Prefix-cache mode admits one request at a time, so that a request
        can hit the pages registered by the one admitted just before it."""
        batchable: List = []
        for slot, occupant in enumerate(self.slot_req):
            if occupant is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            if self.prefix_cache or self._chunked(req):
                if not self._admit_one(slot, req):
                    break
                continue
            s_pad = _bucket(len(req.prompt))
            if s_pad > self._max_seq_padded:
                raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds max_seq")
            if self.paged and not self._reserve(slot, req, s_pad):
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
                self._admit_batch(head)

    def _admit_one(self, slot: int, req: Request) -> bool:
        """Admit one request into the empty `slot`: claim it for a chunked
        prefill, or prefill it now (only the suffix past a prefix-cache
        hit). False, with the request back at the head of the queue, when
        the page pool is short."""
        if self._chunked(req):
            if len(req.prompt) > self._max_seq_padded:
                raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds max_seq")
            start = 0
            if self.prefix_cache:
                start, shared = self.pcache.match_prefix(req.prompt)
                if start:
                    self.pcache.attach(slot, shared)
                    self.stats.prefix_cached_tokens += start
            self.slot_req[slot] = req
            self._set_slot_sampling(slot, req)
            self._prefilling[slot] = start
            # The batched decode writes every slot's new k/v at its length,
            # so a mid-prefill slot parks its write on its last row, which
            # no decode reads (a request ends at lens + 1 == the padded
            # max_seq) and a final chunk covering it rewrites first. Paged,
            # that row's page is not allocated until then: the write goes to
            # the reserved page 0.
            self.lens_np[slot] = self._max_seq_padded - 1
            return True
        s_pad = _bucket(len(req.prompt))
        if s_pad > self._max_seq_padded:
            raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds max_seq")
        n_cached, shared = self.pcache.match_prefix(req.prompt) if self.prefix_cache else (0, [])
        if not n_cached:
            if self.paged and not self._reserve(slot, req, s_pad):
                return False
            self.slot_req[slot] = req
            self._admit_batch([(slot, req)])
            return True
        # Prefix hit: attach the shared pages and prefill only the suffix,
        # whose queries attend over the cached prefix. The pages reserved
        # cover the padded suffix, as JAX reserves them.
        suffix = req.prompt[n_cached:]
        width = max(128, next_power_of_2(len(suffix)))
        if n_cached + width > self._max_seq_padded:
            width = round_up_to_multiple(len(suffix), 128)
        page = self.kv_cfg.page_size
        self.pcache.attach(slot, shared)
        if not self._reserve(slot, req, -(-(n_cached + width) // page) * page):
            return False
        next_tok, next_lp = self._chunk(slot, req, suffix, width, n_cached)
        self.stats.prefix_cached_tokens += n_cached
        self.stats.prefill_tokens += len(suffix)
        self._finish_admission(slot, req, next_tok, next_lp)
        return True

    def _step_chunk_prefills(self):
        """Advance every mid-prefill slot by ONE chunk; a prompt's final
        chunk gives its first token."""
        C = self.prefill_chunk
        for slot in list(self._prefilling):
            req = self.slot_req[slot]
            pos = self._prefilling[slot]
            chunk = req.prompt[pos:pos + C]
            if self.paged:
                decoding = [v for v, r in enumerate(self.slot_req)
                            if r is not None and v not in self._prefilling]
                self._ensure_or_preempt(slot, pos + len(chunk), decoding)
            next_tok, next_lp = self._chunk(slot, req, chunk, C, pos)
            pos += len(chunk)
            self.stats.prefill_tokens += len(chunk)
            if pos >= len(req.prompt):
                del self._prefilling[slot]
                self._finish_admission(slot, req, next_tok, next_lp)
            else:
                self._prefilling[slot] = pos

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
                if self.prefix_cache:
                    # Publish the generated tokens' full pages too, so that a
                    # follow-up turn (prompt + generation + more) reuses them.
                    # The last token was never fed back: its k/v were never
                    # written.
                    new = req.out_tokens[req.folded:]
                    self.pcache.register_prefix(slot, list(req.prompt) + new[:-1])
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

    def _ensure_or_preempt(self, slot: int, n_tokens: int, candidates: List[int]):
        """Pages for `n_tokens` rows of `slot`, preempting the live slot of
        `candidates` that holds the most pages while the pool is dry."""
        while True:
            try:
                self.pcache.ensure_capacity(slot, n_tokens)
                return
            except MemoryError:
                victims = [v for v in candidates if v != slot and self.slot_req[v] is not None]
                if not victims:
                    raise
                self._preempt(max(victims, key=lambda x: len(self.pcache._slot_pages[x])))

    def _make_room(self, active: List[int]):
        """Paged mode, before a decode step: release the pages behind an
        all-layer window (decode never reads them again), then give every
        active slot room for its next token."""
        if self._window >= 0:
            page = self.kv_cfg.page_size
            for s in active:
                behind = int(self.lens_np[s]) - self._window
                if behind > 0:
                    self.pcache.release_prefix(s, behind // page)
        for s in active:
            if self.slot_req[s] is not None:   # not preempted earlier this step
                self._ensure_or_preempt(s, int(self.lens_np[s]) + 1, active)

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: admit waiting requests, advance mid-prefill
        slots by one chunk, then decode all active slots by one token."""
        self._admit()
        if self._prefilling:
            self._step_chunk_prefills()
        active = [s for s, r in enumerate(self.slot_req)
                  if r is not None and s not in self._prefilling]
        if not active:
            return bool(self._prefilling)
        if self.paged:
            self._make_room(active)
            active = [s for s in active if self.slot_req[s] is not None]
            if not active:
                return bool(self.queue)
        next_tokens, next_lps = self._decode(active)
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


class DataParallelEngine:
    """Serving across the mesh's `data` axis (JAX l.934-1011): one TP
    `Engine` a data slice (its own slots, caches and `model` group) fed
    from a SHARED request queue by free capacity.

    Every rank runs this object the same way, and each steps only its own
    replica's engine (`engine`). The shared queue's dispatch needs every
    replica's free capacity, so each step first gathers the replicas'
    (free, busy) counts over the data group; a request goes to the replica
    JAX's `max(free)` picks (ties to the highest index), recorded in
    `replica_of`. `run` returns when no replica is busy, and then gives every
    rank every request's tokens and log-probs (each gathered from the
    replica that served it)."""

    def __init__(self, params: LlamaModel, cfg: LlamaConfig, mesh, n_slots: int = 8,
                 max_seq: int = 2048, **engine_kw):
        extra = {a: n for a, n in axis_sizes(mesh).items()
                 if a not in (AXIS_DATA, AXIS_MODEL) and n > 1}
        if extra:
            raise ValueError(f"a serving mesh has only data / model axes, got {extra}")
        self.n_replicas = axis_size(mesh, AXIS_DATA)
        self.replica = axis_rank(mesh, AXIS_DATA)
        self.data_group = axis_group(mesh, AXIS_DATA) if self.n_replicas > 1 else None
        sub = mesh[AXIS_MODEL] if axis_size(mesh, AXIS_MODEL) > 1 else None
        self.engine = Engine(params, cfg, n_slots=n_slots, max_seq=max_seq, mesh=sub, **engine_kw)
        self.queue: List[Request] = []
        self.requests: List[Request] = []
        self.replica_of: Dict[int, int] = {}
        self._rid = 0

    def submit(self, prompt: List[int], max_new_tokens: int,
               sampling: Optional[SamplingParams] = None, stop_ids=None) -> Request:
        req = Request(rid=self._rid, prompt=list(prompt), max_new_tokens=max_new_tokens,
                      sampling=sampling or GREEDY,
                      stop_ids=frozenset(stop_ids) if stop_ids else None)
        self._rid += 1
        self.queue.append(req)
        self.requests.append(req)
        return req

    def _counts(self) -> List[List[int]]:
        """Every replica's [free capacity, busy] (JAX's free: empty slots
        less its queue), in replica order."""
        e = self.engine
        mine = [sum(r is None for r in e.slot_req) - len(e.queue),
                int(bool(e.queue) or any(r is not None for r in e.slot_req))]
        if self.data_group is None:
            return [mine]
        return all_gather_ints(mine, self.data_group)

    def _dispatch(self, counts: List[List[int]]):
        """Feed the shared queue to the replica with the most free
        capacity, as JAX's `max((free, i))` picks it."""
        free = [c[0] for c in counts]
        while self.queue:
            best_free, best = max((f, i) for i, f in enumerate(free))
            if best_free <= 0:
                return
            req = self.queue.pop(0)
            self.replica_of[req.rid] = best
            free[best] -= 1
            if best == self.replica:
                self.engine.queue.append(req)

    def step(self) -> bool:
        """Dispatch, then step this rank's replica; True if any replica
        progressed."""
        self._dispatch(self._counts())
        progressed = int(self.engine.step())
        if self.data_group is None:
            return bool(progressed)
        return any(p[0] for p in all_gather_ints([progressed], self.data_group))

    def run(self, requests: Optional[List[Request]] = None) -> EngineStats:
        if requests:
            self.queue.extend(requests)
            self.requests.extend(requests)
        t0 = time.perf_counter()
        while self.queue or any(c[1] for c in self._counts()):
            if not self.step() and not self.queue:
                break
        wall = time.perf_counter() - t0
        self._share_results()
        agg = EngineStats(wall_s=wall)
        for st in self._all_stats():
            agg.prefill_tokens += st[0]
            agg.decode_tokens += st[1]
            agg.prefix_cached_tokens += st[2]
            agg.prefill_dispatches += st[3]
            agg.decode_steps = max(agg.decode_steps, st[4])
        return agg

    def _all_stats(self) -> List[List[int]]:
        s = self.engine.stats
        mine = [s.prefill_tokens, s.decode_tokens, s.prefix_cached_tokens, s.prefill_dispatches,
                s.decode_steps]
        if self.data_group is None:
            return [mine]
        return all_gather_ints(mine, self.data_group)

    def _share_results(self):
        """Every request's tokens, log-probs and done flag on every rank,
        from the replica that served it."""
        if self.data_group is None:
            return
        mine = {r.rid: (r.out_tokens, r.out_logprobs, r.done) for r in self.requests
                if self.replica_of.get(r.rid) == self.replica}
        parts: List[Any] = [None] * self.n_replicas
        dist.all_gather_object(parts, mine, group=self.data_group)
        served = {rid: res for part in parts for rid, res in part.items()}
        for r in self.requests:
            if r.rid in served:
                r.out_tokens, r.out_logprobs, r.done = (list(served[r.rid][0]),
                                                        list(served[r.rid][1]), served[r.rid][2])
