"""The port's sampler (`runtime/sampling.py`) and its serving integration
against the JAX package's.

Random bits: `random_bits` equals `jax.random.bits(fold_in(PRNGKey(seed),
step), (V,))` bit for bit over a grid of seeds (2**31 and above included)
and steps. Adjusted logits: the same -inf entries and the finite ones to
1e-6. Tokens: equal to JAX's on every draw, and every draw's top-two margin
of (adjusted logits + Gumbel noise) is asserted above 1e-4 (1e-3 for a
greedy row's raw logits, as `test_torch_serving.py` asserts), since the two
libraries' log and exp may differ in the last bit. Log-probs within 1e-5
(sampler) and 1e-4 (Engine, on `tests/torch_engine.py`'s tiny model).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.runtime import Engine as JaxEngine
from fa2_triton_tpu.runtime import SamplingParams as JaxSamplingParams
from fa2_triton_tpu.runtime import sampling as js

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.runtime import Engine, SamplingParams  # noqa: E402
from fa2_triton_tpu_torch.runtime import sampling as ts  # noqa: E402
from tests.torch_engine import (  # noqa: E402, F401 (models: a fixture)
    DRAW_MARGIN, J_CFG, LP_TOL, T_CFG, ChoiceMargins, choice_margins, models,
)

V = 200
# Per row: (temperature, top_k, top_p, seed) — greedy, each cut alone and
# together, a nucleus of one token, top_k 1 at a high temperature.
ROWS = ((0.0, 0, 1.0, 3), (0.8, 0, 1.0, 1), (1.0, 50, 1.0, 2), (0.7, 0, 0.9, 2**31 + 9),
        (0.8, 50, 0.95, 2**32 - 1), (1.0, 0, 0.05, 5), (5.0, 1, 1.0, 6), (3.0, 20, 0.5, 2**31))


def _logits(seed=0, n=len(ROWS)):
    return np.random.RandomState(seed).normal(0, 3, (n, V)).astype(np.float32)


def _columns(rows, steps):
    t, k, p, s = (np.array(c) for c in zip(*rows))
    return t.astype(np.float32), k.astype(np.int32), p.astype(np.float32), s.astype(np.uint32), \
        np.asarray(steps, np.int32)


@pytest.mark.parametrize("seed", [0, 7, 123456, 2**31 - 1, 2**31 + 5, 2**32 - 1])
def test_random_bits_match_jax_bitwise(seed):
    steps = [0, 1, 17, 40000, 2**31 - 1]
    got = ts.random_bits(torch.full((len(steps),), seed), torch.tensor(steps), 1000).numpy()
    for row, step in zip(got, steps):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), step)
        want = np.asarray(jax.random.bits(key, (1000,))).astype(np.int64)
        np.testing.assert_array_equal(row, want)
        # The uniforms come from the same bits: JAX's uniform(minval=tiny).
        u = np.asarray(jax.random.uniform(key, (1000,), minval=np.finfo(np.float32).tiny))
        g = ts._gumbel(torch.tensor([seed]), torch.tensor([step]), 1000)[0].numpy()
        np.testing.assert_allclose(np.exp(-np.exp(-g.astype(np.float64))), u, rtol=2e-6, atol=0)


@pytest.mark.parametrize("row", range(len(ROWS)))
def test_adjust_logits_row_matches_jax(row):
    temp, top_k, top_p, _ = ROWS[row]
    x = _logits()[row]
    want = np.asarray(js.adjust_logits_row(jnp.asarray(x), jnp.float32(temp), jnp.int32(top_k),
                                           jnp.float32(top_p)))
    got = ts.adjust_logits_row(torch.from_numpy(x), temp, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    live = ~np.isinf(want)
    assert live.sum() >= 1
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 9])
def test_sample_tokens_with_logprobs_matches_jax(step):
    logits = _logits(step)
    cols = _columns(ROWS, [step + i for i in range(len(ROWS))])
    j_tok, j_lp = js.sample_tokens_with_logprobs(jnp.asarray(logits), *map(jnp.asarray, cols))
    t_tok, t_lp = ts.sample_tokens_with_logprobs(torch.from_numpy(logits), *cols[:3],
                                                 cols[3].astype(np.int64), cols[4])
    assert choice_margins(logits, *cols).min() > DRAW_MARGIN
    assert t_tok.tolist() == np.asarray(j_tok).tolist()
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=0, atol=1e-5)


def test_greedy_rules_and_full_nucleus():
    """temperature 0 is argmax at any seed and step; top_k 1 is argmax at
    any temperature; top_p 1 keeps the whole support (a cumsum just below
    1 must not cut it to the argmax), so logits moved by 1e-6 draw the same
    tokens."""
    x = torch.from_numpy(_logits(4))
    n = x.shape[0]
    argmax = x.argmax(-1)
    for temp, top_k in ((0.0, 0), (5.0, 1)):
        for seed, step in ((0, 0), (99, 7)):
            tok = ts.sample_tokens(x, [temp] * n, [top_k] * n, [1.0] * n, [seed] * n, [step] * n)
            assert tok.tolist() == argmax.tolist()
    full = ([1.0] * n, [0] * n, [1.0] * n, [5] * n, [0] * n)
    base = ts.sample_tokens(x, *full)
    for eps in (1e-6, -1e-6, 3e-7):
        assert ts.sample_tokens(x + eps, *full).tolist() == base.tolist()
    assert base.tolist() != argmax.tolist()


# ---------------------------------------------------------------- engine --

HOT = dict(temperature=0.8, top_k=20, top_p=0.95, seed=1234)


def _serve_both(models, monkeypatch, prompts, new, samplings, **engine_kw):
    jp, tm = models
    runs = []
    for make, sp_cls in ((lambda: JaxEngine(jp, J_CFG, **engine_kw), JaxSamplingParams),
                         (lambda: Engine(tm, T_CFG, **engine_kw), SamplingParams)):
        engine = make()
        margins = ChoiceMargins(engine, monkeypatch) if isinstance(engine, Engine) else None
        reqs = [engine.submit(p, n, sampling=sp_cls(**sp) if sp else None)
                for p, n, sp in zip(prompts, new, samplings)]
        engine.run()
        assert all(r.done and len(r.out_tokens) == n for r, n in zip(reqs, new))
        runs.append((engine, reqs, margins))
    (_, j_reqs, _), (engine, t_reqs, margins) = runs
    margins.check()
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.out_tokens == jr.out_tokens
        assert tr.folded == jr.folded
        np.testing.assert_allclose(tr.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)
    return engine, t_reqs


def test_engine_sampled_request_matches_jax(models, monkeypatch):
    """One sampled request (temperature 0.8, top-k 20, top-p 0.95) beside a
    hot one (temperature 8): JAX's tokens draw for draw; the hot one is not
    the greedy stream, and a fresh engine reproduces both."""
    prompt = list(range(3, 12))
    samplings = [HOT, dict(temperature=8.0, seed=7), None]
    engine, reqs = _serve_both(models, monkeypatch, [prompt] * 3, [8] * 3, samplings,
                               n_slots=2, max_seq=256)
    assert reqs[1].out_tokens != reqs[2].out_tokens
    again = Engine(models[1], T_CFG, n_slots=2, max_seq=256)
    rerun = [again.submit(prompt, 8, sampling=SamplingParams(**sp) if sp else None)
             for sp in samplings]
    again.run()
    assert [r.out_tokens for r in rerun] == [r.out_tokens for r in reqs]


def test_engine_mixed_greedy_and_sampled_batch_matches_jax(models, monkeypatch):
    """Greedy and sampled requests share batched prefills and decode steps
    (one step samples every slot); each equals JAX's, and the greedy one
    equals its solo run."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in (9, 12, 10, 33)]
    samplings = [None, dict(temperature=5.0, seed=11), HOT, None]
    _, reqs = _serve_both(models, monkeypatch, prompts, [6, 5, 7, 4], samplings, n_slots=4,
                          max_seq=256)
    solo = Engine(models[1], T_CFG, n_slots=1, max_seq=256)
    ref = solo.submit(prompts[0], 6)
    solo.run()
    assert reqs[0].out_tokens == ref.out_tokens


def test_preempted_sampled_request_resumes_its_stream(models, monkeypatch):
    """Paged pool of 3 usable pages of 128 for two 100-token prompts that
    each grow past a page: a request is preempted mid-generation, re-prefills
    its prompt and tokens so far, and resumes its stream at step
    len(out_tokens); tokens and folds equal JAX's, and equal an unpreempted
    run of the same sampled request."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 128, size=100).tolist() for _ in range(2)]
    samplings = [HOT, dict(temperature=1.0, top_p=0.9, seed=2**31 + 3)]
    engine, reqs = _serve_both(models, monkeypatch, prompts, [40, 40], samplings, n_slots=2,
                               max_seq=256, paged=True, n_pages=4, page_size=128)
    assert any(r.folded for r in reqs)
    assert engine.pcache.free_pages == 3
    roomy = Engine(models[1], T_CFG, n_slots=2, max_seq=256, paged=True, page_size=128)
    ref = [roomy.submit(p, 40, sampling=SamplingParams(**sp)) for p, sp in zip(prompts, samplings)]
    roomy.run()
    assert not any(r.folded for r in ref)
    assert [r.out_tokens for r in ref] == [r.out_tokens for r in reqs]
