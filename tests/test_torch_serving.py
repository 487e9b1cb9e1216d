"""The port's continuous-batching `Engine` against the JAX `Engine` on the
same converted weights, and against greedy decoding with its own full
forward.

vocab 128, dim 128, 2 layers, 4/2 heads, fp32, 2 slots. Prompts of 9 and 11
tokens share bucket 64 (one batched N=2 prefill); the 300-token prompt waits
for a free slot and prefills alone in bucket 512 (the B9 tri-square kernel
on the JAX side). Greedy tokens must be equal and log-probs within 1e-4;
every step's top-1 margin is checked to exceed 10x that tolerance, so equal
tokens are a sound check and not a coin toss between near ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.runtime import Engine as JaxEngine

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.runtime import Engine, SamplingParams  # noqa: E402

LP_TOL = 1e-4
J_CFG = jl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=512, dtype=jnp.float32)
T_CFG = tl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=512, dtype=torch.float32)
PROMPT_LENS = (9, 11, 300)
NEW = (5, 6, 4)


@pytest.fixture(scope="module")
def setup():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tm = llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in PROMPT_LENS]
    return jp, tm, prompts


def _serve(engine, prompts):
    reqs = [engine.submit(p, n) for p, n in zip(prompts, NEW)]
    stats = engine.run()
    assert all(r.done for r in reqs)
    return reqs, stats


def test_engine_matches_jax_engine(setup):
    jp, tm, prompts = setup
    j_reqs, _ = _serve(JaxEngine(jp, J_CFG, n_slots=2, max_seq=512), prompts)
    engine = Engine(tm, T_CFG, n_slots=2, max_seq=512)
    t_reqs, stats = _serve(engine, prompts)
    assert stats.prefill_dispatches == 2          # one N=2 batch + the 300-token prompt
    assert stats.prefill_tokens == sum(PROMPT_LENS)
    assert stats.decode_tokens == sum(NEW) - len(NEW)
    for p, jr, tr in zip(prompts, j_reqs, t_reqs):
        # Top-1 margins of the token choices, from the port's full forward.
        with torch.no_grad():
            logits = tl.forward(tm, torch.tensor([p + tr.out_tokens[:-1]]))[0, len(p) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 10 * LP_TOL
        assert tr.out_tokens == jr.out_tokens
        np.testing.assert_allclose(tr.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)


def test_engine_matches_own_greedy_forward(setup):
    """Greedy decode by repeated full forward passes (slow oracle)."""
    _, tm, prompts = setup
    t_reqs, _ = _serve(Engine(tm, T_CFG, n_slots=2, max_seq=512), prompts)
    for p, r, n in zip(prompts, t_reqs, NEW):
        toks = list(p)
        with torch.no_grad():
            for _ in range(n):
                toks.append(int(tl.forward(tm, torch.tensor([toks]))[0, -1].argmax()))
        assert r.out_tokens == toks[len(p):]


def test_inactive_slots_step_harmlessly(setup):
    """One request on a 4-slot engine: the three idle slots decode a stale
    token over kv_len 1 every step; nothing goes NaN and the active request
    matches a run with no idle slots."""
    _, tm, prompts = setup
    solo = Engine(tm, T_CFG, n_slots=1, max_seq=512)
    r1 = solo.submit(prompts[0], 6)
    solo.run()
    eng = Engine(tm, T_CFG, n_slots=4, max_seq=512)
    r4 = eng.submit(prompts[0], 6)
    eng.run()
    assert r4.out_tokens == r1.out_tokens
    np.testing.assert_allclose(r4.out_logprobs, r1.out_logprobs, rtol=0, atol=LP_TOL)
    assert all(torch.isfinite(c["k"]).all() and torch.isfinite(c["v"]).all() for c in eng.caches)


def test_eos_and_stop_ids(setup):
    _, tm, prompts = setup
    ref = Engine(tm, T_CFG, n_slots=2, max_seq=512)
    r = ref.submit(prompts[1], 6)
    ref.run()
    out = r.out_tokens
    eng = Engine(tm, T_CFG, n_slots=2, max_seq=512, eos_id=out[2])
    r_eos = eng.submit(prompts[1], 6)
    r_stop = eng.submit(prompts[1], 6, stop_ids=[out[1]])
    eng.run()
    # Generation ends at the first emitted stop token, which is kept.
    assert r_eos.out_tokens == out[:out.index(out[2]) + 1]
    assert r_stop.out_tokens == out[:out.index(out[1]) + 1]


@pytest.mark.parametrize("kw", [dict(prefill_chunk=128), dict(prefix_cache=True), dict(mesh=object())])
def test_unported_engine_options_raise(setup, kw):
    _, tm, _ = setup
    with pytest.raises(NotImplementedError):
        Engine(tm, T_CFG, n_slots=2, max_seq=512, **kw)


def test_sampling_temperature_raises(setup):
    _, tm, prompts = setup
    eng = Engine(tm, T_CFG, n_slots=2, max_seq=512)
    with pytest.raises(NotImplementedError, match="temperature"):
        eng.submit(prompts[0], 3, sampling=SamplingParams(temperature=0.7, seed=1))


def test_greedy_selection_matches_jax():
    """First-max argmax (ties included) and the chosen token's raw-model
    logprob, as `jnp.argmax` / `jax.nn.log_softmax` give them."""
    from fa2_triton_tpu.runtime import sampling as js
    from fa2_triton_tpu_torch.runtime import sampling as ts

    logits = np.random.RandomState(3).normal(0, 2, (4, 50)).astype(np.float32)
    logits[2, 7] = logits[2, 31] = logits[2].max() + 1.0   # a tie: the first index wins
    j_tok, j_lp = js.greedy_tokens_with_logprobs(jnp.asarray(logits))
    for fn in (ts.greedy_tokens_with_logprobs,
               lambda x: ts.sample_tokens_with_logprobs(x, torch.zeros(4), None, None, None, None)):
        t_tok, t_lp = fn(torch.from_numpy(logits))
        assert t_tok.tolist() == np.asarray(j_tok).tolist() and int(t_tok[2]) == 7
        np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="temperature"):
        ts.sample_tokens_with_logprobs(torch.from_numpy(logits), torch.full((4,), 0.5),
                                       None, None, None, None)
