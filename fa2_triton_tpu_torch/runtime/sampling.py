"""Token selection for the serving engine (port of
`fa2_triton_tpu.runtime.sampling`).

Per-request temperature / top-k / top-p (nucleus) sampling, batched over the
rows of a logits tensor as torch ops on its device. Token i of a request is
drawn from `fold_in(PRNGKey(seed), i)` exactly as the JAX engine draws it:
threefry2x32 is integer arithmetic, so `_threefry2x32` reproduces JAX's keys
and `jax.random.bits` bit for bit (`jax_threefry_partitionable`: the counter
of element j is the 64-bit iota j split into (hi, lo) words, and the two
output words are XORed), and with them its uniforms in [tiny, 1). The
uint32 words live in int64 tensors masked to 32 bits, since torch's uint32
support is partial. The Gumbel noise -log(-log(u)) and the nucleus softmax
go through each library's own log and exp, which may differ in the last
bit: a draw equals JAX's wherever the top-two gap of (adjusted logits +
Gumbel noise) is wider than that. So a request reproduces itself, and a
preempted request that re-prefills its partial generation resumes the same
stream (its step counter is the number of tokens it has generated).

temperature == 0 is greedy (first-max argmax, as `jnp.argmax`). The log-prob
returned with a token is always its log-prob under the raw model
distribution.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls. Defaults reproduce greedy decode."""
    temperature: float = 0.0   # 0 => argmax
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1.0 => disabled
    seed: int = 0              # taken modulo 2**32, as a uint32

    def __post_init__(self):
        if self.temperature < 0.0 or self.top_k < 0 or not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"bad sampling params {self}")


GREEDY = SamplingParams()

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_NEG_INF = float("-inf")


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """x (a tensor, array or list) as a `dtype` tensor on `device`. Host
    values reach a CUDA device by a non-blocking copy from pinned memory,
    so the host does not wait for the device's queue to drain."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.as_tensor(x, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's `threefry2x32_p`) on int64
    tensors holding uint32 words; the four operands broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(seeds: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] int64 holding `jax.random.bits(fold_in(PRNGKey(seeds[b]),
    steps[b]), (n,))` as uint32 words. PRNGKey(s) is the key (0, s),
    fold_in(key, i) is threefry(key, (0, i)), and element j is
    threefry(key, (0, j)) with its two words XORed."""
    seeds = seeds.to(torch.int64)[:, None] & _M32
    steps = steps.to(torch.int64)[:, None] & _M32
    zero = torch.zeros_like(seeds)
    k0, k1 = _threefry2x32(zero, seeds, zero, steps)
    iota = torch.arange(n, dtype=torch.int64, device=seeds.device)[None]
    y0, y1 = _threefry2x32(k0, k1, torch.zeros_like(iota), iota)
    return y0 ^ y1


def _gumbel(seeds: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] fp32 Gumbel noise: `jax.random.gumbel` (mode "low") on each
    row's key, -log(-log(u)) with u `jax.random.uniform(minval=tiny)` of
    the same bits."""
    bits = random_bits(seeds, steps, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, dtype=torch.float32, device=bits.device)
    u = torch.maximum(tiny, floats * (1.0 - tiny) + tiny)
    return -torch.log(-torch.log(u))


def adjust_logits(logits: torch.Tensor, temps, top_ks, top_ps) -> torch.Tensor:
    """Temperature-scale then top-k / top-p-truncate each row of logits
    [B, V] (JAX `adjust_logits_row` on every row): fp32, -inf at the
    truncated entries, so softmax of a row is the distribution its token is
    drawn from. top_k 0 and top_p >= 1 are off; top-p keeps the smallest
    prefix of the sorted distribution whose mass reaches top_p (the crossing
    token stays in), its threshold clamped to the row's total mass."""
    V = logits.shape[-1]
    dev = logits.device
    temps = _on(temps, torch.float32, dev)[:, None]
    top_ks = _on(top_ks, torch.int64, dev)[:, None]
    top_ps = _on(top_ps, torch.float32, dev)[:, None]
    neg_inf = torch.tensor(_NEG_INF, dtype=torch.float32, device=dev)
    scaled = logits.float() / torch.clamp(temps, min=1e-6)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.where(top_ks > 0, desc.gather(-1, (top_ks - 1).clamp(0, V - 1)), neg_inf)
    scaled = torch.where(scaled >= kth, scaled, neg_inf)
    # jax.nn.softmax: exp(x - max) / sum.
    e = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    thresh = torch.minimum(top_ps, csum[:, -1:])
    cutoff = sp.gather(-1, (csum >= thresh).to(torch.int32).argmax(dim=-1, keepdim=True))
    return torch.where((top_ps >= 1.0) | (probs >= cutoff), scaled, neg_inf)


def adjust_logits_row(logits: torch.Tensor, temp: float, top_k: int, top_p: float) -> torch.Tensor:
    """One logits row [V] adjusted as `adjust_logits` adjusts a batch."""
    return adjust_logits(logits[None], [temp], [top_k], [top_p])[0]


def sample_tokens(logits, temps, top_ks, top_ps, seeds, steps) -> torch.Tensor:
    """Per-row token [B] (int64) of logits [B, V]: argmax where temps <= 0,
    else the Gumbel-max draw (`jax.random.categorical`) from the adjusted
    row with the key fold_in(PRNGKey(seeds[b]), steps[b]), so each row's
    stream is independent of what else shares the batch."""
    dev = logits.device
    temps, seeds, steps = (_on(x, dt, dev) for x, dt in ((temps, torch.float32),
                                                         (seeds, torch.int64),
                                                         (steps, torch.int64)))
    adjusted = adjust_logits(logits, temps, top_ks, top_ps)
    drawn = torch.argmax(_gumbel(seeds, steps, logits.shape[-1]) + adjusted, dim=-1)
    return torch.where(temps <= 0.0, torch.argmax(logits, dim=-1), drawn)


def _raw_logprobs(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, toks[:, None])[:, 0]


def sample_tokens_with_logprobs(logits, temps, top_ks, top_ps, seeds, steps):
    """`sample_tokens` and each chosen token's log-prob under the raw model
    distribution (independent of temperature and truncation)."""
    toks = sample_tokens(logits, temps, top_ks, top_ps, seeds, steps)
    return toks, _raw_logprobs(logits, toks)


def greedy_tokens_with_logprobs(logits: torch.Tensor):
    """Argmax per row [B, V] and the chosen token's raw-model log-prob: the
    engine's path when every row is greedy (no sort, no random bits)."""
    toks = torch.argmax(logits, dim=-1)
    return toks, _raw_logprobs(logits, toks)
