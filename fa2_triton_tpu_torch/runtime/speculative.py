"""Speculative decoding (draft and verify) on the KV-cache forward (port of
`fa2_triton_tpu/runtime/speculative.py`).

A small draft model proposes `gamma` tokens one at a time; the target model
scores all of them in ONE cached forward over gamma + 1 rows
(`models/llama.py:forward_with_cache`, whose attention is
`ops/attention.py:flash_attn_with_kv_cache`: the B1 forward kernel with the
rows at a global offset). A round emits between 1 and gamma + 1 tokens for
one target pass.

- **Greedy** (`sampling=None` or temperature 0): the longest prefix of the
  proposals that matches the target's argmaxes is accepted, plus the
  target's own next token, so the stream is the target's greedy decode
  (`greedy_reference`).
- **Sampled** (temperature > 0): speculative sampling. Proposals are drawn
  from the draft's adjusted distribution q, each is accepted with
  probability min(1, p / q) under the target's equally adjusted p, and the
  first rejection resamples from max(p - q, 0) (`spec_accept`), so the
  stream is distributed as target-only sampling. The random events are
  JAX's: `fold_in(PRNGKey(seed), 0)` draws the prefill token; round r draws
  its draft step i from `fold_in(fold_in(base, 2r + 1), i)` and accepts and
  resamples with `fold_in(base, 2r + 2)` (`runtime/sampling.py`'s key
  algebra, bit for bit), so a (seed, prompt) pair reproduces itself.

JAX runs the draft loop as one `lax.scan` and verify + accept as one jitted
call, to pay one TPU dispatch each. Here they are plain loops of eager
steps whose tokens stay on the device: a round reads the host once, for its
proposals, the verify pass's tokens and the accept decision together.

Caches are fixed buffers addressed by a host length, so rejecting tokens
is not advancing the length: stale rows are overwritten by the next write
at that position. The prompt is prefilled at its own length, so only its
true rows are written (JAX pads it to max(64, next power of 2) and writes
the padding too, which refuses a prompt whose padded length passes
`max_seq`: ROADMAP.md queue C).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from fa2_triton_tpu_torch.models.llama import (
    LlamaConfig, LlamaModel, forward_with_cache, init_kv_cache, make_cached_attention_fn,
)
from fa2_triton_tpu_torch.runtime.sampling import (
    SamplingParams, adjust_logits, categorical, fold_in, prng_key, softmax, split, uniform,
)


def spec_accept(p_probs: torch.Tensor, q_probs: torch.Tensor, proposals: torch.Tensor,
                key: torch.Tensor):
    """The speculative-sampling accept / reject / resample rule (JAX
    `speculative.py:spec_accept`), on the device with no host read.

    p_probs [gamma + 1, V]: the target's probabilities at the verify rows
    (row i scores proposal i, row gamma is the bonus position); q_probs
    [gamma, V]: the draft's, the proposals' distributions; proposals
    [gamma] int; key [2]: split into the accept uniforms' key and the
    resample's. Returns 0-d int64 tensors (k, next): k proposals accepted
    (a prefix), and the token after them: a draw from the residual
    max(p - q, 0) at the first rejection, or from the bonus row when all
    were accepted."""
    gamma = q_probs.shape[0]
    u_key, r_key = split(key)
    idx = torch.arange(gamma, device=p_probs.device)
    proposals = proposals.long()
    p_at, q_at = p_probs[idx, proposals], q_probs[idx, proposals]
    u = uniform(u_key, (gamma,))
    accept = u * q_at < p_at                            # u < min(1, p / q)
    k = torch.cumprod(accept.long(), dim=0).sum()
    j = torch.clamp(k, max=gamma - 1)
    p_j = p_probs[j]
    residual = torch.clamp(p_j - q_probs[j], min=0.0)
    # A residual of no mass (p == q exactly; unreachable in exact arithmetic)
    # falls back to p, as JAX does.
    residual = torch.where(residual.sum() > 0.0, residual, p_j)
    row = torch.where(k == gamma, p_probs[gamma], residual)
    logits = torch.where(row > 0.0, torch.log(row), torch.full_like(row, float("-inf")))
    return k, categorical(r_key, logits)


@dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    target_calls: int = 0       # verify passes (the prefill excluded)
    draft_calls: int = 0
    emitted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_target_call(self) -> float:
        return self.emitted / self.target_calls if self.target_calls else 0.0


class SpeculativeDecoder:
    """Single-sequence speculative decoding of `target` with `draft` (both
    `LlamaModel`s on one device). `generate(prompt, max_new_tokens,
    sampling=None)` returns (tokens, SpecStats); greedy, the tokens are the
    target's greedy decode."""

    def __init__(self, target: LlamaModel, target_cfg: LlamaConfig,
                 draft: LlamaModel, draft_cfg: LlamaConfig,
                 gamma: int = 4, max_seq: int = 2048, eos_id: Optional[int] = None):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.target, self.tcfg = target, target_cfg
        self.draft, self.dcfg = draft, draft_cfg
        self.gamma = gamma
        self.max_seq = max_seq
        self.eos_id = eos_id
        self._tattn = make_cached_attention_fn(target_cfg)
        self._dattn = make_cached_attention_fn(draft_cfg)
        self.device = target.embed.device

    def _target_step(self, tokens, caches, cache_len: int) -> torch.Tensor:
        return forward_with_cache(self.target, tokens, self.tcfg, caches, cache_len, self._tattn)[0]

    def _draft_step(self, tokens, caches, cache_len: int) -> torch.Tensor:
        return forward_with_cache(self.draft, tokens, self.dcfg, caches, cache_len, self._dattn)[0]

    def _prefill(self, prompt: List[int], max_new_tokens: int):
        """Fresh caches with the prompt's true rows in both models: (the
        target's logits at the last prompt row [V], target caches, draft
        caches)."""
        L = len(prompt)
        if L < 1 or L + max_new_tokens + self.gamma + 1 > self.max_seq:
            raise ValueError(f"need 1 <= prompt length {L} and {L} + max_new_tokens "
                             f"{max_new_tokens} + gamma {self.gamma} + 1 <= max_seq {self.max_seq}")
        t_caches = init_kv_cache(self.tcfg, 1, self.max_seq, device=self.device)
        d_caches = init_kv_cache(self.dcfg, 1, self.max_seq, device=self.device)
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits = self._target_step(tokens, t_caches, 0)
        self._draft_step(tokens, d_caches, 0)
        return logits[0, L - 1], t_caches, d_caches

    def _emit(self, out: List[int], new: List[int], max_new_tokens: int) -> None:
        """Append a round's tokens, cut after an EOS and at max_new_tokens."""
        if self.eos_id is not None and self.eos_id in new:
            new = new[: new.index(self.eos_id) + 1]
        out.extend(new[: max_new_tokens - len(out)])

    def _running(self, out: List[int], max_new_tokens: int) -> bool:
        return len(out) < max_new_tokens and (self.eos_id is None or out[-1] != self.eos_id)

    @torch.inference_mode()
    def generate(self, prompt: List[int], max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None):
        if sampling is not None and sampling.temperature > 0.0:
            return self._generate_sampled(prompt, max_new_tokens, sampling)
        last_logits, t_caches, d_caches = self._prefill(prompt, max_new_tokens)
        stats = SpecStats()
        gamma, dev = self.gamma, self.device
        t_len = len(prompt)
        out = [int(torch.argmax(last_logits))]
        while self._running(out, max_new_tokens):
            # The draft proposes gamma tokens from the accepted state.
            row = [torch.tensor([[out[-1]]], dtype=torch.long, device=dev)]
            for i in range(gamma):
                dl = self._draft_step(row[-1], d_caches, t_len + i)
                row.append(torch.argmax(dl[:, -1], dim=-1, keepdim=True))
            stats.draft_calls += gamma
            # The target scores [last] + proposals in one pass over gamma + 1 rows.
            row = torch.cat(row, dim=1)
            greedy = torch.argmax(self._target_step(row, t_caches, t_len)[0], dim=-1)
            both = torch.cat([row[0, 1:], greedy]).tolist()    # the round's one host read
            proposals, greedy = both[:gamma], both[gamma:]
            stats.target_calls += 1
            stats.rounds += 1
            stats.proposed += gamma
            k = 0
            while k < gamma and proposals[k] == greedy[k]:
                k += 1
            stats.accepted += k
            self._emit(out, proposals[:k] + [greedy[k]], max_new_tokens)
            if k == gamma:
                # Full accept: the draft cache lacks the last proposal's row
                # (proposed, never fed): one discarded draft step writes it.
                self._draft_step(row[:, -1:], d_caches, t_len + gamma)
                stats.draft_calls += 1
            # The target cache holds [last] + proposals: k + 1 rows are kept.
            t_len += k + 1
        stats.emitted = len(out)
        return out, stats

    def _generate_sampled(self, prompt: List[int], max_new_tokens: int, sp: SamplingParams):
        """Speculative sampling on JAX's event schedule (module docstring)."""
        last_logits, t_caches, d_caches = self._prefill(prompt, max_new_tokens)
        stats = SpecStats()
        gamma, dev = self.gamma, self.device
        base = prng_key(sp.seed, device=dev)
        samp = [torch.tensor([x] * (gamma + 1), dtype=dt, device=dev)
                for x, dt in ((sp.temperature, torch.float32), (sp.top_k, torch.int64),
                              (sp.top_p, torch.float32))]
        samp1 = [x[:1] for x in samp]
        t_len = len(prompt)
        out = [int(categorical(fold_in(base, 0), adjust_logits(last_logits[None], *samp1)[0]))]
        r = 0
        while self._running(out, max_new_tokens):
            root = fold_in(base, 2 * r + 1)
            row, q = [torch.tensor([[out[-1]]], dtype=torch.long, device=dev)], []
            for i in range(gamma):
                adj = adjust_logits(self._draft_step(row[-1], d_caches, t_len + i)[:, -1], *samp1)
                q.append(softmax(adj))
                row.append(categorical(fold_in(root, i), adj[0]).view(1, 1))
            stats.draft_calls += gamma
            row = torch.cat(row, dim=1)
            p = softmax(adjust_logits(self._target_step(row, t_caches, t_len)[0], *samp))
            k, nxt = spec_accept(p, torch.cat(q), row[0, 1:], fold_in(base, 2 * r + 2))
            got = torch.cat([row[0, 1:], k.view(1), nxt.view(1)]).tolist()   # one host read
            proposals, k, nxt = got[:gamma], got[gamma], got[gamma + 1]
            stats.target_calls += 1
            stats.rounds += 1
            stats.proposed += gamma
            stats.accepted += k
            self._emit(out, proposals[:k] + [nxt], max_new_tokens)
            if k == gamma:
                self._draft_step(row[:, -1:], d_caches, t_len + gamma)
                stats.draft_calls += 1
            t_len += k + 1
            r += 1
        stats.emitted = len(out)
        return out, stats


@torch.inference_mode()
def greedy_reference(model: LlamaModel, cfg: LlamaConfig, prompt: List[int],
                     max_new_tokens: int, max_seq: int = 2048,
                     eos_id: Optional[int] = None) -> List[int]:
    """Token-by-token greedy decode through the same cached path (the oracle
    of the speculative decoder): a prefill at the prompt's length, then
    width-1 steps. Tokens stay on the device between steps; the host reads
    each one only to look for `eos_id`, else all of them at the end."""
    L = len(prompt)
    if L < 1 or L + max_new_tokens > max_seq:
        raise ValueError(f"need 1 <= prompt length {L} and {L} + max_new_tokens "
                         f"{max_new_tokens} <= max_seq {max_seq}")
    dev = model.embed.device
    attn = make_cached_attention_fn(cfg)
    caches = init_kv_cache(cfg, 1, max_seq, device=dev)
    tokens = torch.tensor([prompt], dtype=torch.long, device=dev)
    logits = forward_with_cache(model, tokens, cfg, caches, 0, attn)[0]
    toks = [torch.argmax(logits[:, L - 1], dim=-1, keepdim=True)]
    for n in range(L, L + max_new_tokens - 1):
        if eos_id is not None and int(toks[-1]) == eos_id:
            break
        logits = forward_with_cache(model, toks[-1], cfg, caches, n, attn)[0]
        toks.append(torch.argmax(logits[:, 0], dim=-1, keepdim=True))
    return torch.cat(toks, dim=1)[0].tolist()
