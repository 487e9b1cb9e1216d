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

Speculative sampling (`runtime/speculative.py`) keys its draws on any key,
not only (seed, step): `prng_key`, `fold_in`, `split`, `bits`, `uniform`,
`gumbel` and `categorical` are `jax.random`'s on int64 key tensors [..., 2],
bit for bit up to the floats (`uniform`'s mantissa trick is exact;
`gumbel`'s logs are each library's own).

temperature == 0 is greedy (first-max argmax, as `jnp.argmax`). The log-prob
returned with a token is always its log-prob under the raw model
distribution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

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
    tensors holding uint32 words; the four operands broadcast, and the
    counter words may be ints."""
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


# ---------------------------------------------------------------------------
# JAX's key algebra (`jax.random` with `jax_threefry_partitionable`, the
# default) on int64 key tensors [..., 2] holding the two uint32 words. The
# leading dims of a key are a batch of keys; an int `data` or `seed` never
# leaves the host, so these build no tensor from a host value.


def prng_key(seed, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the words (0, seed mod 2**32), [2] for an
    int seed (on `device`), [..., 2] for an int tensor of seeds."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(torch.int64) & _M32
        return torch.stack([torch.zeros_like(s), s], dim=-1)
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: both words of threefry(key, (0,
    data)); `data` an int or an int tensor broadcasting with key[..., 0]."""
    d = data.to(torch.int64) & _M32 if isinstance(data, torch.Tensor) else int(data) & _M32
    return torch.stack(_threefry2x32(key[..., 0], key[..., 1], 0, d), dim=-1)


def _counter_words(key: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry(key, (0, j)) for j the flat index of `shape` (JAX's
    `iota_2x32_shape`; the high word is 0 below 2**32 elements): two
    [*key.shape[:-1], *shape] tensors of words."""
    shape = tuple(shape)
    iota = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    y0, y1 = _threefry2x32(key[..., 0, None], key[..., 1, None], 0, iota)
    out = (*key.shape[:-1], *shape)
    return y0.reshape(out), y1.reshape(out)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [..., num, 2], key j being both words
    of threefry(key, (0, j)), not XORed."""
    return torch.stack(_counter_words(key, (num,)), dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32 words in int64): element j is
    threefry(key, (0, j)) with its two words XORed."""
    y0, y1 = _counter_words(key, shape)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: the top 23
    bits as a mantissa in [1, 2), minus 1, then scaled, shifted and clamped
    below by minval in fp32."""
    b = bits(key, shape)
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=b.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=b.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` (mode "low"): -log(-log(u)) with u
    `uniform(minval=tiny)` of the same bits."""
    return -torch.log(-torch.log(uniform(key, shape, minval=torch.finfo(torch.float32).tiny)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last dim: the argmax
    of logits + Gumbel noise (first max on ties, as `jnp.argmax`). A key
    [2] draws every row of logits from one stream of noise over their flat
    shape, as JAX does; a batch of keys [..., 2] leads logits' dims, one
    key a row (the Engine's per-request keys)."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` over the last dim: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def random_bits(seeds: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] int64 holding `jax.random.bits(fold_in(PRNGKey(seeds[b]),
    steps[b]), (n,))` as uint32 words."""
    return bits(fold_in(prng_key(seeds), steps), (n,))


def _gumbel(seeds: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] fp32 Gumbel noise of each row's key fold_in(PRNGKey(seeds[b]),
    steps[b])."""
    return gumbel(fold_in(prng_key(seeds), steps), (n,))


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
    probs = softmax(scaled)
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
