"""Perplexity eval, corpus training and resume, and the serving demo of the
port, against the JAX package where it has a counterpart.

- `examples/eval.py:evaluate` on a JAX `init_params` tree converted with
  `llama_from_jax_params` against JAX's `loss_fn` over the same corpus
  windows: 1e-5 relative (fp32 on both sides; summation order differs).
- Three guarded `--data` steps of the trainer's step functions against
  three `optax.chain(clip_by_global_norm(1.0), adamw(3e-4, weight_decay=
  0.01))` steps on the same windows: the three losses and the loss after
  them within 1e-5, and the parameters within 1e-5 wherever JAX's gradient
  was 0 or above VANISHING at every step. Adam divides each element's step by
  its own gradient's size, so where a gradient is near 0 its fp32 rounding
  noise (~1e-9 here) sets the step's size and sign; those elements (under
  0.1 % of them) are held to the most three AdamW steps can move them.
- Four uninterrupted `--data` steps against two, then two resumed from
  `--ckpt-dir`, bit for bit (the same CPU operations in the same order).
"""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.utils import data as jdata

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.examples import eval as teval  # noqa: E402
from fa2_triton_tpu_torch.examples import train as ttrain  # noqa: E402
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import (  # noqa: E402
    llama_from_jax_params, llama_to_jax_params)
from fa2_triton_tpu_torch.runtime import serving_demo  # noqa: E402
from fa2_triton_tpu_torch.utils.data import TokenLoader, encode_corpus, open_corpus  # noqa: E402
from fa2_triton_tpu_torch.utils.resilience import make_guarded_step  # noqa: E402

TOL = 1e-5
VANISHING = 1e-6
V, SEQ, BATCH, STEPS = 128, 17, 2, 3
KW = dict(vocab_size=V, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
          max_seq_len=64, rope_theta=10000.0)
J_CFG = jl.LlamaConfig(dtype=jnp.float32, **KW)
T_CFG = tl.LlamaConfig(dtype=torch.float32, **KW)
# The trainer's small model (vocab 32000) at a tiny width, on the CPU.
TRAIN_ARGV = ["--device", "cpu", "--dim", "64", "--layers", "1", "--seq", str(SEQ),
              "--batch", str(BATCH)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A corpus, JAX's params, and JAX's eval losses and three optax steps
    over its windows, computed once."""
    d = tmp_path_factory.mktemp("corpus")
    path = str(d / "corpus.bin")
    jdata.encode_corpus(np.random.RandomState(0).randint(0, V, size=1 + 24 * 16), path, V)
    params = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    loss = jax.jit(lambda p, t: jl.loss_fn(p, t, J_CFG))
    loader = jdata.TokenLoader(jdata.open_corpus(path, V), BATCH, SEQ - 1, seed=0)
    eval_losses = [float(loss(params, jnp.asarray(b))) for b in itertools.islice(loader, 3)]

    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(optax.constant_schedule(3e-4), weight_decay=0.01))

    @jax.jit
    def step(p, o, t):
        lval, grads = jax.value_and_grad(lambda q: jl.loss_fn(q, t, J_CFG))(p)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, lval, grads

    p, o, train_losses = params, opt.init(params), []
    least = jax.tree.map(lambda x: np.full(x.shape, np.inf, np.float32), params)
    batches = list(itertools.islice(iter(loader), STEPS + 1))
    for b in batches[:STEPS]:
        p, o, lval, grads = step(p, o, jnp.asarray(b))
        train_losses.append(float(lval))
        least = jax.tree.map(  # exact zeros (unseen embedding rows) are exact in both
            lambda a, g: np.minimum(a, np.where(np.asarray(g) != 0, np.abs(np.asarray(g)), np.inf)),
            least, grads)
    return {"path": path, "params": jax.tree.map(np.asarray, params), "eval": eval_losses,
            "train": train_losses, "trained": jax.tree.map(np.asarray, p), "least_grad": least,
            "after": float(loss(p, jnp.asarray(batches[STEPS])))}


def test_evaluate_matches_jax_loss_fn(ref):
    model = llama_from_jax_params(ref["params"], T_CFG, device="cpu")
    loader = TokenLoader(open_corpus(ref["path"], V), BATCH, SEQ - 1, seed=0)
    nll, n = teval.evaluate(model, T_CFG, loader, 3)
    want = float(np.mean(ref["eval"]))
    assert n == 3 and abs(nll - want) <= TOL * abs(want)


def test_three_data_steps_match_optax(ref):
    model = llama_from_jax_params(ref["params"], T_CFG, device="cpu")
    args = ttrain.parse_args(TRAIN_ARGV + ["--data", ref["path"], "--steps", str(STEPS)])
    state = {"model": model, "opt": ttrain.make_optimizer(model, args.lr), "step": 0}
    guarded = make_guarded_step(*ttrain.step_fns(
        T_CFG, lambda s: ttrain.lr_at(s, args.lr, args.steps, args.warmup), args.grad_clip))
    losses = []
    for b in ttrain.host_batches(args, V, 0):
        state, loss, ok = guarded(state, torch.from_numpy(b))
        assert ok
        losses.append(float(loss))
    with torch.no_grad():
        after = ttrain.model_loss(T_CFG)(model, torch.from_numpy(
            next(ttrain.host_batches(ttrain.parse_args(TRAIN_ARGV + ["--data", ref["path"],
                                                                     "--steps", str(STEPS + 1)]),
                                     V, STEPS))).long())
    np.testing.assert_allclose(losses + [float(after)], ref["train"] + [ref["after"]], rtol=0,
                               atol=TOL)
    got = llama_to_jax_params(model)
    vanishing = total = 0
    for path, want in jax.tree_util.tree_leaves_with_path(ref["trained"]):
        leaf, least = got, ref["least_grad"]
        for key in path:
            k = key.key if hasattr(key, "key") else key.idx
            leaf, least = leaf[k], least[k]
        live = least >= VANISHING
        vanishing, total = vanishing + int((~live).sum()), total + live.size
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(leaf[live], want[live], rtol=0, atol=TOL, err_msg=name)
        np.testing.assert_allclose(leaf[~live], want[~live], rtol=0,
                                   atol=2 * STEPS * args.lr, err_msg=name)
    assert vanishing < 1e-3 * total, (vanishing, total)


@pytest.fixture()
def corpus(tmp_path):
    path = str(tmp_path / "corpus.bin")
    encode_corpus(np.random.RandomState(5).randint(0, 64, size=1 + 7 * (SEQ - 1)), path, 32000)
    return path


def test_resume_continues_the_corpus_bit_for_bit(tmp_path, corpus):
    """7 windows of 16: 3 steps an epoch, so the resumed steps 2-3 cross
    into epoch 1. JAX's trainer would feed window 0's batch again at step
    2 (`examples/train.py:150-152` restarts its loader on resume)."""
    data = TRAIN_ARGV + ["--data", corpus]
    full = ttrain.run(ttrain.parse_args(data + ["--steps", "4"]))
    ck = str(tmp_path / "ckpt")
    first = ttrain.run(ttrain.parse_args(data + ["--steps", "2", "--ckpt-dir", ck]))
    resumed = ttrain.run(ttrain.parse_args(data + ["--steps", "4", "--ckpt-dir", ck]))
    assert (first["start"], resumed["start"]) == (0, 2)
    assert resumed["report"].resumed_from == 2 and resumed["report"].restore_s is not None
    assert first["losses"] + resumed["losses"] == full["losses"]      # bit for bit
    assert len(set(full["losses"])) == 4

    args = ttrain.parse_args(data + ["--steps", "4"])
    stream = list(ttrain.host_batches(args, 32000, 0))
    assert np.array_equal(next(ttrain.host_batches(args, 32000, 2)), stream[2])
    jax_restart = next(iter(jdata.TokenLoader(jdata.open_corpus(corpus, 32000), BATCH, SEQ - 1)))
    assert np.array_equal(jax_restart, stream[0]) and not np.array_equal(jax_restart, stream[2])


def test_random_tokens_resume_from_the_restored_step(tmp_path):
    """Without --data, a run resumed at step s draws from RandomState(s), as
    the JAX script does; the model, optimizer and LR schedule continue."""
    args = ttrain.parse_args(TRAIN_ARGV + ["--steps", "3"])
    want = np.random.RandomState(2).randint(0, 32000, size=(BATCH, SEQ)).astype(np.int32)
    assert np.array_equal(next(ttrain.host_batches(args, 32000, 2)), want)
    ck = str(tmp_path / "ckpt")
    ttrain.run(ttrain.parse_args(TRAIN_ARGV + ["--steps", "2", "--ckpt-dir", ck]))
    resumed = ttrain.run(ttrain.parse_args(TRAIN_ARGV + ["--steps", "3", "--ckpt-dir", ck]))
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1
    done = ttrain.run(ttrain.parse_args(TRAIN_ARGV + ["--steps", "3", "--ckpt-dir", ck]))
    assert done["start"] == 3 and done["losses"] == []


def test_eval_cli_reads_the_trainers_checkpoint(tmp_path, corpus, capsys):
    ck = str(tmp_path / "ckpt")
    ttrain.run(ttrain.parse_args(TRAIN_ARGV + ["--data", corpus, "--steps", "3", "--lr", "3e-3",
                                               "--ckpt-dir", ck]))
    argv = ["--device", "cpu", "--dim", "64", "--layers", "1", "--seq", "16", "--batch", "2",
            "--batches", "2", "--data", corpus]
    fresh = teval.main(argv)
    trained = teval.main(argv + ["--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert trained["step"] == 3 and "evaluating checkpoint step 3" in out
    assert "2 batches (64 tokens): cross-entropy" in out and "perplexity" in out
    assert np.isfinite(trained["nll"]) and trained["nll"] < fresh["nll"]


@pytest.mark.parametrize("extra", [[], ["--paged"], ["--qdtype", "int8"],
                                   ["--prefix-cache", "--shared-prefix", "128"]])
def test_serving_demo_prints_its_json_line_on_the_cpu(capsys, extra):
    res = serving_demo.main(["--device", "cpu", "--dim", "128", "--layers", "1", "--heads", "4",
                             "--kv-heads", "2", "--slots", "2", "--max-seq", "512",
                             "--requests", "3", "--prompt-len", "40", "--new-tokens", "3"]
                            + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "tokens/s" and line["value"] > 0 and line["device"] == "cpu"
    assert line["metric"] == "serving_decode_tokens_per_s" + ("_int8" if "int8" in extra else "")
    assert res["stats"].decode_tokens == 3 * (3 - 1)     # the first token comes from prefill
    if "--prefix-cache" in extra:
        assert res["stats"].prefix_cached_tokens == 2 * 128


def test_serving_demo_tp_raises():
    """`--tp N` is ported (N ranks, tests/test_torch_serving_tp.py runs
    `--tp 2`); a degree below 1 raises."""
    with pytest.raises(ValueError, match="--tp"):
        serving_demo.main(["--device", "cpu", "--tp", "0"])
