"""The port's speculative decoding (`runtime/speculative.py`), its cached
forward (`models/llama.py:forward_with_cache`, `ops/attention.py:
flash_attn_with_kv_cache`) and the key algebra under it
(`runtime/sampling.py`) against the JAX package's, on the CPU.

Tolerances and margins:
- keys, bits and uniforms: bit for bit (threefry is integer arithmetic and
  `uniform` a mantissa trick); a `categorical` draw equals JAX's where its
  top-two gap of (logits + Gumbel noise) exceeds DRAW_MARGIN (the Gumbel
  noise goes through each library's log, which may differ in the last bit);
- `flash_attn_with_kv_cache` fp32 within 1e-5 (sums in another order; the
  JAX kernel runs in interpret mode); cached-forward logits within 1e-4;
- greedy streams and all six `SpecStats` fields equal, with every argmax
  the decoders take asserted to beat its runner-up by GREEDY_MARGIN
  (logits agree to ~3e-6, so a near tie could flip);
- sampled streams equal draw for draw, with every draw's gap above
  DRAW_MARGIN and every accept decision that counts (up to the first
  rejection) at least ACCEPT_MARGIN away from u * q == p;
- the speculative-sampling theorem on the port's `spec_accept`: total
  variation under 0.03 over 6000 draws, as the JAX suite asks.

The JAX references are computed once per module: one JAX decoder per
(target, draft) pair, its greedy calls at several gammas (its jitted steps
are cached by width), so the file stays within its time budget.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.ops.attention import flash_attn_with_kv_cache as j_kv_attn
from fa2_triton_tpu.runtime.sampling import SamplingParams as JSamplingParams
from fa2_triton_tpu.runtime.speculative import SpeculativeDecoder as JSpeculativeDecoder
from fa2_triton_tpu.runtime.speculative import spec_accept as j_spec_accept

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_to_jax_params  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_with_kv_cache  # noqa: E402
from fa2_triton_tpu_torch.ops import flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.runtime import SpeculativeDecoder  # noqa: E402
from fa2_triton_tpu_torch.runtime import sampling as ts  # noqa: E402
from fa2_triton_tpu_torch.runtime import speculative  # noqa: E402
from fa2_triton_tpu_torch.runtime.sampling import SamplingParams  # noqa: E402

# tests/test_speculative.py's target and draft.
T_KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
            max_seq_len=256)
D_KW = dict(vocab_size=128, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64,
            max_seq_len=256)
MAX_SEQ = 256
GREEDY_MARGIN = 1e-3
DRAW_MARGIN = 1e-4
ACCEPT_MARGIN = 1e-5
WEAK_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
PERFECT_PROMPT = list(range(5, 14))
EOS_PROMPT = list(range(7))
SAMPLED = dict(temperature=0.9, top_k=40, top_p=0.95)
SAMPLED_PROMPT = [2, 7, 1, 8]


def _models(kw, seed):
    """A random port model on the CPU (its init is quick; JAX's takes
    seconds) and the same weights as a JAX tree."""
    cfg = tl.LlamaConfig(dtype=torch.float32, **kw)
    model = tl.init_params(torch.Generator().manual_seed(seed), cfg)
    return jax.tree.map(jnp.asarray, llama_to_jax_params(model)), model, cfg


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, its cfg, JAX draft, port draft, its cfg)."""
    return (*_models(T_KW, 0), *_models(D_KW, 1))


def _jcfg(kw):
    return jl.LlamaConfig(dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def jax_decoder(models):
    """One JAX decoder of the target with the weak draft: its jitted steps
    are cached by width, so every run below shares them."""
    jt, _, _, jd, _, _ = models
    return JSpeculativeDecoder(jt, _jcfg(T_KW), jd, _jcfg(D_KW), gamma=1, max_seq=MAX_SEQ)


@pytest.fixture(scope="module")
def jax_runs(jax_decoder):
    """Every JAX decoder run the module compares with, once: greedy at
    gamma 1, at 4, and at 4 with EOS; sampled at 4 (seeds 11 and 12). Each
    is (tokens, SpecStats as a dict)."""
    runs = {}
    for name, gamma, eos, prompt, n, sampling in (
            ("greedy 1", 1, None, WEAK_PROMPT, 12, None),
            ("greedy 4", 4, None, WEAK_PROMPT, 12, None),
            ("eos", 4, EOS_TOKEN, EOS_PROMPT, 12, None),
            ("sampled 11", 4, None, SAMPLED_PROMPT, 10, JSamplingParams(seed=11, **SAMPLED)),
            ("sampled 12", 4, None, SAMPLED_PROMPT, 10, JSamplingParams(seed=12, **SAMPLED))):
        jax_decoder.gamma, jax_decoder.eos_id = gamma, eos
        out, st = jax_decoder.generate(prompt, n, sampling=sampling)
        runs[name] = (out, vars(st))
    return runs


# The target's greedy token 6 after EOS_PROMPT, its first occurrence there
# (asserted in test_eos_truncates_mid_round).
EOS_TOKEN = 96


class Margins:
    """The smallest margin of every choice the port's decoders make while
    the spy is on: the top-two gap of each row of every model step (greedy
    argmaxes), of every categorical draw, and of every accept decision
    that counts."""

    def __init__(self, monkeypatch):
        self.greedy = self.draw = self.accept = float("inf")
        step = speculative.forward_with_cache
        draw, accept = speculative.categorical, speculative.spec_accept

        def step_spy(*args, **kw):
            logits, caches = step(*args, **kw)
            top2 = logits.topk(2, dim=-1).values
            self.greedy = min(self.greedy, float((top2[..., 0] - top2[..., 1]).min()))
            return logits, caches

        def draw_spy(key, logits):
            x = ts.gumbel(key, logits.shape[key.dim() - 1:]) + logits
            top2 = x.topk(2, dim=-1).values
            if torch.isfinite(top2[..., 1]).all():
                self.draw = min(self.draw, float((top2[..., 0] - top2[..., 1]).min()))
            return draw(key, logits)

        def accept_spy(p, q, props, key):
            self.accept = min(self.accept, accept_margin(p, q, props, key))
            return accept(p, q, props, key)

        monkeypatch.setattr(speculative, "forward_with_cache", step_spy)
        monkeypatch.setattr(speculative, "categorical", draw_spy)
        monkeypatch.setattr(speculative, "spec_accept", accept_spy)


def accept_margin(p, q, props, key) -> float:
    """min |p_at - u q_at| over the accept decisions up to the first
    rejection (the later ones do not move k)."""
    gamma = q.shape[0]
    u = ts.uniform(ts.split(key)[0], (gamma,))
    idx = torch.arange(gamma)
    p_at, q_at = p[idx, props.long()], q[idx, props.long()]
    gap = (p_at - u * q_at).abs()
    rejected = (u * q_at >= p_at).nonzero()
    last = int(rejected[0]) if len(rejected) else gamma - 1
    return float(gap[: last + 1].min())


# --------------------------------------------------------------------------
# The key algebra


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1, 2**31 + 5, 2**32 - 1])
def test_key_algebra_is_jax_bit_for_bit(seed):
    jbase, tbase = jax.random.PRNGKey(np.uint32(seed)), ts.prng_key(seed)
    same = lambda j, t: np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())
    same(jax.random.key_data(jbase), tbase)
    for r in (0, 1, 7):
        # The decoder's nesting: fold_in(fold_in(base, 2r + 1), i), then split.
        jroot, troot = jax.random.fold_in(jbase, 2 * r + 1), ts.fold_in(tbase, 2 * r + 1)
        same(jroot, troot)
        for i in (0, 3):
            same(jax.random.fold_in(jroot, i), ts.fold_in(troot, i))
        jsplit, tsplit = jax.random.split(jroot), ts.split(troot)
        same(jsplit, tsplit)
        same(jax.random.split(jroot, 5), ts.split(troot, 5))
        same(jax.random.bits(jsplit[1], (3, 40)), ts.bits(tsplit[1], (3, 40)))
        np.testing.assert_array_equal(np.asarray(jax.random.uniform(jsplit[0], (257,))),
                                      ts.uniform(tsplit[0], (257,)).numpy())


@pytest.mark.parametrize("seed", [3, 4000])
def test_categorical_matches_jax(seed):
    logits = np.random.RandomState(seed).normal(0, 2, (6, 500)).astype(np.float32)
    logits[1, ::3] = -np.inf                  # truncated entries, as adjust_logits leaves
    key = ts.fold_in(ts.prng_key(seed), 5)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    rows = ts.split(key, 6)
    for j, t in ((jax.random.categorical(jkey, logits), ts.categorical(key, torch.from_numpy(logits))),
                 (jax.vmap(jax.random.categorical)(jax.random.split(jkey, 6), logits),
                  ts.categorical(rows, torch.from_numpy(logits)))):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    for k, shape in ((key, logits.shape), (rows, logits.shape[1:])):
        x = ts.gumbel(k, shape) + torch.from_numpy(logits)
        top2 = x.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > DRAW_MARGIN


# --------------------------------------------------------------------------
# The cached attention and forward

KV_CASES = {   # name: (S_step, kv_len, Hkv, window_left, softcap)
    "decode first row": (1, 1, 2, -1, 0.0),
    "decode gqa 4 softcap": (1, 100, 1, -1, 5.0),
    "verify window": (5, 77, 2, 16, 0.0),
    "verify mha window softcap": (5, 128, 4, 30, 5.0),
}


@pytest.mark.parametrize("case", list(KV_CASES))
def test_flash_attn_with_kv_cache_matches_jax(case):
    S, kv_len, Hkv, window, softcap = KV_CASES[case]
    rng = np.random.RandomState(len(case))
    B, Hq, D, S_max = 2, 4, 32, 160
    q = rng.normal(0, 0.5, (B, S, Hq, D)).astype(np.float32)
    k, v = (rng.normal(0, 0.5, (B, S_max, Hkv, D)).astype(np.float32) for _ in range(2))
    want = j_kv_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(kv_len),
                     window_left=window, softcap=softcap)
    bhsd = lambda x: torch.from_numpy(x).transpose(1, 2)
    n0 = flash_fwd.LAUNCHES
    got = flash_attn_with_kv_cache(torch.from_numpy(q), bhsd(k), bhsd(v), kv_len,
                                   window_left=window, softcap=softcap)
    assert flash_fwd.LAUNCHES == n0          # CPU tensors: the plain twin, no launch
    assert got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_flash_attn_with_kv_cache_refuses():
    q, kc = torch.zeros(1, 2, 4, 64), torch.zeros(1, 2, 16, 64)
    with pytest.raises(TypeError):
        flash_attn_with_kv_cache(q, kc, kc, torch.tensor(4))       # a device read per call
    with pytest.raises(TypeError):
        flash_attn_with_kv_cache(q, kc, kc, 4, block_q=128)        # TPU tiles: queue A.3
    for kv_len in (1, 17):
        with pytest.raises(ValueError):
            flash_attn_with_kv_cache(q, kc, kc, kv_len)


def test_forward_with_cache_matches_jax(models, jax_decoder, jax_runs):
    """A 9-token prefill, then steps of 5 and 2 rows, against JAX's
    `forward_with_cache` (the JAX decoder's jitted target steps at widths
    64, 5 and 2: its prefill pads the prompt to 64 rows; its caches are
    BSHD, the port's BHSD)."""
    jt, tt, tcfg = models[:3]
    toks = np.random.RandomState(5).randint(0, 128, (1, 16))
    padded = np.zeros((1, 64), np.int64)
    padded[:, :9] = toks[:, :9]
    jc, tc = jl.init_kv_cache(_jcfg(T_KW), 1, MAX_SEQ), tl.init_kv_cache(tcfg, 1, 80, device="cpu")
    with torch.inference_mode():
        for lo, hi, x in ((0, 9, padded), (9, 14, toks[:, 9:14]), (14, 16, toks[:, 14:])):
            want, jc = jax_decoder._step(x.shape[1], "t")(jt, jnp.asarray(x, jnp.int32), jc,
                                                          jnp.int32(lo))
            got, _ = tl.forward_with_cache(tt, torch.from_numpy(toks[:, lo:hi]), tcfg, tc, lo,
                                           tl.make_cached_attention_fn(tcfg))
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :hi - lo], rtol=0,
                                       atol=1e-4)
    for (jk, jv), (k, v) in zip(jc, tc):
        for j, t in ((jk, k), (jv, v)):
            np.testing.assert_allclose(t[:, :, :16].numpy(),
                                       np.asarray(j)[:, :16].transpose(0, 2, 1, 3), rtol=0,
                                       atol=1e-5)
            assert not t[:, :, 16:].any()    # only true rows are written
    with pytest.raises(ValueError, match="pass the cache"):
        tl.forward_with_cache(tt, torch.zeros(1, 2, dtype=torch.long), tcfg, tc, 79,
                              tl.make_cached_attention_fn(tcfg))


def test_per_layer_cached_attention_fn(models):
    """A model with alternating windows gets the per-layer (`li`) form, a
    plain one the bare form, as JAX's `make_cached_attention_fn` chooses;
    the cached steps then equal the full forward, whose windows per layer
    are `make_attention_fn`'s."""
    plain = models[2]
    cfg = tl.LlamaConfig(dtype=torch.float32, sliding_window=6, alt_window=True, **T_KW)
    assert "li" in inspect.signature(tl.make_cached_attention_fn(cfg)).parameters
    assert "li" not in inspect.signature(tl.make_cached_attention_fn(plain)).parameters
    model = tl.init_params(torch.Generator().manual_seed(2), cfg)
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 128, (1, 20)))
    caches = tl.init_kv_cache(cfg, 1, 32, device="cpu")
    with torch.inference_mode():
        full = tl.forward(model, toks)
        attn = tl.make_cached_attention_fn(cfg)
        steps = [tl.forward_with_cache(model, toks[:, lo:hi], cfg, caches, lo, attn)[0]
                 for lo, hi in ((0, 13), (13, 18), (18, 19), (19, 20))]
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# Greedy speculative decoding


def _stats(st):
    return vars(st)


@pytest.mark.parametrize("gamma", [1, 4])
def test_greedy_matches_jax(models, jax_runs, monkeypatch, gamma):
    _, tt, tcfg, _, td, dcfg = models
    margins = Margins(monkeypatch)
    dec = SpeculativeDecoder(tt, tcfg, td, dcfg, gamma=gamma, max_seq=MAX_SEQ)
    out, st = dec.generate(WEAK_PROMPT, 12)
    assert margins.greedy > GREEDY_MARGIN, margins.greedy
    assert (out, _stats(st)) == jax_runs[f"greedy {gamma}"]
    assert out == speculative.greedy_reference(tt, tcfg, WEAK_PROMPT, 12, max_seq=MAX_SEQ)
    assert st.emitted == 12 and st.emitted >= st.rounds


def test_eos_matches_jax(models, jax_runs, monkeypatch):
    _, tt, tcfg, _, td, dcfg = models
    margins = Margins(monkeypatch)
    dec = SpeculativeDecoder(tt, tcfg, td, dcfg, gamma=4, max_seq=MAX_SEQ, eos_id=EOS_TOKEN)
    out, st = dec.generate(EOS_PROMPT, 12)
    assert margins.greedy > GREEDY_MARGIN, margins.greedy
    assert (out, _stats(st)) == jax_runs["eos"]
    assert out[-1] == EOS_TOKEN and len(out) < 12


def test_perfect_draft_accepts_everything(models, monkeypatch):
    """draft == target: every proposal accepted, gamma + 1 tokens a pass."""
    _, tt, tcfg = models[:3]
    margins = Margins(monkeypatch)
    dec = SpeculativeDecoder(tt, tcfg, tt, tcfg, gamma=3, max_seq=MAX_SEQ)
    out, st = dec.generate(PERFECT_PROMPT, 13)
    assert margins.greedy > GREEDY_MARGIN, margins.greedy
    assert st.acceptance_rate == 1.0
    assert st.target_calls == -(-(13 - 1) // 4)
    assert out == speculative.greedy_reference(tt, tcfg, PERFECT_PROMPT, 13, max_seq=MAX_SEQ)


def test_eos_truncates_mid_round(models):
    """A perfect draft at gamma 4 emits tokens 1-5 of the reference in its
    first round and 6-10 in its second; an EOS at token 6 cuts the second
    round after its first token."""
    _, tt, tcfg = models[:3]
    ref = speculative.greedy_reference(tt, tcfg, EOS_PROMPT, 12, max_seq=MAX_SEQ)
    assert ref.index(EOS_TOKEN) == 6
    dec = SpeculativeDecoder(tt, tcfg, tt, tcfg, gamma=4, max_seq=MAX_SEQ, eos_id=EOS_TOKEN)
    out, st = dec.generate(EOS_PROMPT, 12)
    assert out == ref[:7] and st.rounds == 2 and st.accepted == 8
    assert speculative.greedy_reference(tt, tcfg, EOS_PROMPT, 12, max_seq=MAX_SEQ,
                                        eos_id=EOS_TOKEN) == ref[:7]


def test_prompt_past_the_padded_prefill_is_served(models):
    """JAX prefills a prompt padded to max(64, next power of 2) and writes
    the padding into the cache, so it refuses a 70-token prompt in a
    100-row cache (ROADMAP.md queue C); the port writes the true rows."""
    _, tt, tcfg = models[:3]
    prompt = np.random.RandomState(7).randint(0, 128, 70).tolist()
    dec = SpeculativeDecoder(tt, tcfg, tt, tcfg, gamma=4, max_seq=100)
    out, st = dec.generate(prompt, 20)
    assert out == speculative.greedy_reference(tt, tcfg, prompt, 20, max_seq=100)
    assert st.acceptance_rate == 1.0
    with pytest.raises(ValueError, match="max_seq"):
        dec.generate(prompt, 26)


# --------------------------------------------------------------------------
# Speculative sampling


def _tv(a, b):
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def _accept_draws(p, q, key, gamma):
    """Per key of `key` [N, 2]: proposals drawn from q's rows, then the
    port's spec_accept (vmapped: one sample a row)."""
    def one(kk):
        kq, ka = ts.split(kk)
        props = ts.categorical(ts.split(kq, gamma), torch.log(q))
        return (props, *speculative.spec_accept(p, q, props, ka))
    return torch.func.vmap(one)(key)


def test_spec_accept_matches_jax():
    """(k, next) equal to JAX's on fixed p, q and 200 keys, each accept
    decision that counts ACCEPT_MARGIN from its threshold and the
    resample's gap above DRAW_MARGIN."""
    V, gamma, N = 16, 4, 200
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(V), size=gamma + 1).astype(np.float32)
    q = rng.dirichlet(np.full(V, 0.5), size=gamma).astype(np.float32)
    props = rng.integers(0, V, (N, gamma)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    jk, jn = jax.jit(jax.vmap(j_spec_accept, in_axes=(None, None, 0, 0)))(p, q, props, keys)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    tkeys = ts.split(ts.prng_key(9), N)
    tprops = torch.from_numpy(props).long()
    k, nxt = torch.func.vmap(speculative.spec_accept, in_dims=(None, None, 0, 0))(
        tp, tq, tprops, tkeys)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    assert 0 < k.sum() < gamma * N           # both accepts and rejects
    assert min(accept_margin(tp, tq, tprops[n], tkeys[n]) for n in range(N)) > ACCEPT_MARGIN
    for n in range(N):
        kk = int(k[n])
        row = tp[gamma] if kk == gamma else torch.clamp(tp[min(kk, gamma - 1)] -
                                                        tq[min(kk, gamma - 1)], min=0)
        logits = torch.where(row > 0, torch.log(row), float("-inf"))
        x = ts.gumbel(ts.split(tkeys[n])[1], (V,)) + logits
        top2 = x.topk(2).values
        assert float(top2[0] - top2[1]) > DRAW_MARGIN


def test_spec_accept_first_token_distribution():
    """The first emitted token (the proposal if accepted, else the residual
    resample) is distributed as the target's p_0, for a draft q far from p."""
    V, gamma, N = 8, 3, 6000
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(V), size=gamma + 1).astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.full(V, 0.3), size=gamma).astype(np.float32))
    props, k, nxt = _accept_draws(p, q, ts.split(ts.prng_key(42), N), gamma)
    first = torch.where(k > 0, props[:, 0], nxt)
    emp = np.bincount(first.numpy(), minlength=V) / N
    assert _tv(emp, p[0]) < 0.03, (emp, p[0])
    assert (k == 0).any() and (k > 0).any()


def test_spec_accept_full_accept_bonus_row():
    """q == p: every proposal is accepted and the bonus token is drawn from
    the target's last row."""
    V, gamma, N = 8, 2, 6000
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.dirichlet(np.ones(V), size=gamma + 1).astype(np.float32))
    _, k, bonus = _accept_draws(p, p[:gamma], ts.split(ts.prng_key(7), N), gamma)
    assert bool((k == gamma).all())
    assert _tv(np.bincount(bonus.numpy(), minlength=V) / N, p[gamma]) < 0.03


def test_sampled_generate_matches_jax(models, jax_runs, monkeypatch):
    """Equal to JAX's draw for draw (margins asserted), deterministic, in
    the vocab, and decoupled by the seed."""
    _, tt, tcfg, _, td, dcfg = models
    margins = Margins(monkeypatch)
    dec = SpeculativeDecoder(tt, tcfg, td, dcfg, gamma=4, max_seq=MAX_SEQ)
    runs = {seed: dec.generate(SAMPLED_PROMPT, 10, sampling=SamplingParams(seed=seed, **SAMPLED))
            for seed in (11, 12)}
    assert margins.draw > DRAW_MARGIN, margins.draw
    assert margins.accept > ACCEPT_MARGIN, margins.accept
    for seed, (out, st) in runs.items():
        assert (out, _stats(st)) == jax_runs[f"sampled {seed}"]
        assert len(out) == 10 and all(0 <= t < T_KW["vocab_size"] for t in out)
        assert st.emitted >= st.rounds
    assert runs[11][0] != runs[12][0]
    again, _ = dec.generate(SAMPLED_PROMPT, 10, sampling=SamplingParams(seed=11, **SAMPLED))
    assert again == runs[11][0]


def test_sampled_perfect_draft_accepts_everything(models):
    """draft == target: p == q at every proposal, so no rejection."""
    _, tt, tcfg = models[:3]
    dec = SpeculativeDecoder(tt, tcfg, tt, tcfg, gamma=3, max_seq=MAX_SEQ)
    out, st = dec.generate([5, 6, 7], 12, sampling=SamplingParams(temperature=1.0, seed=3))
    assert len(out) == 12 and st.acceptance_rate == 1.0


def test_temperature_zero_is_greedy(models):
    _, tt, tcfg, _, td, dcfg = models
    dec = SpeculativeDecoder(tt, tcfg, td, dcfg, gamma=2, max_seq=MAX_SEQ)
    out, _ = dec.generate([3, 1, 4, 1, 5], 8, sampling=SamplingParams())
    assert out == speculative.greedy_reference(tt, tcfg, [3, 1, 4, 1, 5], 8, max_seq=MAX_SEQ)
