"""The port's checkpoints (`utils/checkpoint.py`) and guarded, resumable
training (`utils/resilience.py`) against the JAX package's: `test_aux.py`'s
checkpoint round trip and resilient-trainer test on the port, the toy
`{"w": ones(4)}` trainer of that test run through both packages (equal
losses, verdicts, final state and saved steps, bit for bit: the same fp32
operations on both sides), and the skip of a non-finite step on a small
model, which must leave the parameters, the AdamW moments and the step
count bit for bit as they were.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.utils import resilience as jres
from fa2_triton_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.examples import train as ttrain  # noqa: E402
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from fa2_triton_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from fa2_triton_tpu_torch.utils.resilience import (  # noqa: E402
    ResilientTrainer, devices_healthy, make_guarded_multi_step, make_guarded_step,
    tree_allfinite)

REPO = Path(__file__).resolve().parents[1]
CFG = tl.LlamaConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64,
                     max_seq_len=64, dtype=torch.float32)
# The toy stream: batch 2 is NaN and must be skipped by both packages.
TOY_BATCHES = [1.0, 1.0, float("nan"), 0.5, 1.0, 2.0]


def _model(seed=0):
    return tl.init_params(torch.Generator().manual_seed(seed), CFG, device="cpu")


# ---------------- checkpoints ------------------------------------------------

def test_checkpoint_save_restore_roundtrip(tmp_path):
    params = _model().state_dict()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(1, params)
    mgr.save(2, {k: v + 1.0 for k, v in params.items()})
    assert mgr.latest_step() == 2
    restored = mgr.restore(params)
    assert torch.equal(restored["layers.0.wq"], params["layers.0.wq"] + 1.0)
    restored1 = mgr.restore(params, step=1)
    assert torch.equal(restored1["layers.0.wq"], params["layers.0.wq"])
    mgr.save(3, params)
    assert mgr.all_steps() == [2, 3]        # only the newest max_to_keep stay
    mgr.close()


def test_restore_places_like_the_like_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"w": torch.arange(4.0), "opt": {"m": torch.ones(2)}, "step": 4})
    out = mgr.restore({"w": torch.zeros(4, dtype=torch.float64), "step": 0})
    assert out["w"].dtype == torch.float64 and out["step"] == 4
    assert torch.equal(out["opt"]["m"], torch.ones(2))   # not named: loaded as saved
    with pytest.raises(ValueError, match="expected \\(5,\\)"):
        mgr.restore({"w": torch.zeros(5)})
    with pytest.raises(KeyError, match="lacks"):
        mgr.restore({"v": torch.zeros(4)})


def test_restore_without_a_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore({"w": torch.zeros(2)})


def test_a_crash_during_a_save_leaves_the_last_step_readable(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"w": torch.full((3,), 2.0)})
    real_save = torch.save

    def crash(obj, f):
        real_save(obj, f)
        f.truncate(7)                          # half written, then the process dies
        raise OSError("disk gone")

    monkeypatch.setattr(tckpt.torch, "save", crash)
    with pytest.raises(OSError, match="disk gone"):
        mgr.save(3, {"w": torch.full((3,), 3.0)})
    monkeypatch.setattr(tckpt.torch, "save", real_save)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2.pt"]
    assert torch.equal(mgr.restore({"w": torch.zeros(3)})["w"], torch.full((3,), 2.0))
    (tmp_path / "5.pt.tmp").write_bytes(b"partial")  # left by a killed process
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    assert not (tmp_path / "5.pt.tmp").exists()


def test_async_save_copies_the_state_to_the_host_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones(1 << 16)
    mgr.save(1, {"w": w}, wait=False)
    w.add_(1.0)                                # the next step updates in place
    mgr.wait_until_finished()
    assert torch.equal(mgr.restore({"w": torch.zeros(1 << 16)})["w"], torch.ones(1 << 16))


# ---------------- the guarded step and the trainer ---------------------------

def _toy_fns():
    """The port's form of test_aux.py's toy step `w -= 0.1 * batch`, loss
    `sum(batch)`: the gradient is the batch, the update its 0.1 multiple."""
    def grad_fn(state, batch):
        return batch.sum(), [batch * torch.ones_like(state["w"])]

    def apply_fn(state, grads):
        state["w"].sub_(0.1 * grads[0])

    return grad_fn, apply_fn


def _jax_toy_step(state, batch):
    return jax.tree.map(lambda p: p - 0.1 * batch, state), jnp.sum(batch)


def test_resilient_trainer_skips_nonfinite_and_resumes(tmp_path):
    assert devices_healthy([torch.device("cpu")])
    assert bool(tree_allfinite({"a": torch.ones(3), "n": torch.arange(3)}))
    assert not bool(tree_allfinite({"a": torch.tensor([1.0, float("nan")])}))

    guarded = make_guarded_step(*_toy_fns())
    state = {"w": torch.ones(4)}
    state, loss, ok = guarded(state, torch.tensor(1.0))
    assert ok and float(state["w"][0]) == pytest.approx(0.9)
    state, loss, ok = guarded(state, torch.tensor(float("nan")))
    assert not ok and float(state["w"][0]) == pytest.approx(0.9)   # never updated

    tr = ResilientTrainer(*_toy_fns(), str(tmp_path), save_every=2)
    s, start = tr.restore_or_init({"w": torch.ones(4)})
    assert start == 0
    s = tr.run(s, [torch.tensor(1.0)] * 4, start_step=start)
    assert tr.report.steps_run == 4
    tr.close()
    tr2 = ResilientTrainer(*_toy_fns(), str(tmp_path), save_every=2)
    s2, start2 = tr2.restore_or_init({"w": torch.ones(4)})
    assert start2 == 4 and tr2.report.resumed_from == 4
    assert torch.equal(s2["w"], s["w"])
    tr2.close()


@pytest.fixture(scope="module")
def jax_toy(tmp_path_factory):
    """JAX's ResilientTrainer over TOY_BATCHES (save_every 2), its guarded
    step's per-step losses and verdicts, and its scanned multi-step."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    tr = jres.ResilientTrainer(_jax_toy_step, str(d), save_every=2)
    s0 = {"w": jnp.ones((4,))}
    state, start = tr.restore_or_init(s0)
    state = tr.run(state, [jnp.float32(b) for b in TOY_BATCHES], start_step=start)
    report = tr.report
    tr.close()
    mgr = JaxCheckpointManager(str(d))
    steps = list(mgr._mgr.all_steps())
    mgr.close()
    guarded = jax.jit(jres.make_guarded_step(_jax_toy_step))
    s, losses, oks = s0, [], []
    for b in TOY_BATCHES:
        s, loss, ok = guarded(s, jnp.float32(b))
        losses.append(float(loss))
        oks.append(bool(ok))
    multi = jax.jit(jres.make_guarded_multi_step(_jax_toy_step))
    ms, mlosses, moks = multi(s0, jnp.asarray(TOY_BATCHES, jnp.float32))
    return {"w": np.asarray(state["w"]), "report": report, "steps": sorted(steps),
            "losses": losses, "oks": oks, "multi": (np.asarray(ms["w"]), np.asarray(mlosses),
                                                    np.asarray(moks))}


def test_toy_trainer_equals_jax(tmp_path, jax_toy):
    tr = ResilientTrainer(*_toy_fns(), str(tmp_path), save_every=2)
    state, start = tr.restore_or_init({"w": torch.ones(4)})
    state = tr.run(state, [torch.tensor(b) for b in TOY_BATCHES], start_step=start)
    tr.close()
    want = jax_toy["report"]
    assert (tr.report.steps_run, tr.report.steps_skipped) == (want.steps_run, want.steps_skipped)
    assert tr.report.steps_skipped == 1
    assert tr.report.last_loss == want.last_loss
    np.testing.assert_array_equal(state["w"].numpy(), jax_toy["w"])
    assert CheckpointManager(str(tmp_path)).all_steps() == jax_toy["steps"]

    guarded = make_guarded_step(*_toy_fns())
    s, losses, oks = {"w": torch.ones(4)}, [], []
    for b in TOY_BATCHES:
        s, loss, ok = guarded(s, torch.tensor(b))
        losses.append(float(loss))
        oks.append(ok)
    np.testing.assert_array_equal(losses, jax_toy["losses"])
    assert oks == jax_toy["oks"]


def test_multi_step_equals_jax_scan(jax_toy):
    multi = make_guarded_multi_step(*_toy_fns())
    s, losses, oks = multi({"w": torch.ones(4)}, torch.tensor(TOY_BATCHES))
    w, jlosses, joks = jax_toy["multi"]
    np.testing.assert_array_equal(s["w"].numpy(), w)
    np.testing.assert_array_equal(losses.numpy(), jlosses)
    np.testing.assert_array_equal(oks.numpy(), joks)


@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a,b", [([1.0, 2.0], [3.0]), ([1.0, float("inf")], [3.0]),
                                 ([1.0], [float("nan")]), ([-0.0, 1e-45], [3.0e38])])
def test_tree_allfinite_equals_jax(a, b, b_dtype):
    want = jres.tree_allfinite({"a": jnp.asarray(a, jnp.float32),
                                "b": [jnp.asarray(b, jnp.float32), jnp.arange(3)]})
    got = tree_allfinite({"a": torch.tensor(a), "b": [torch.tensor(b, dtype=b_dtype),
                                                      torch.arange(3)]})
    assert got.shape == () and bool(got) == bool(want)


def _snapshot(state):
    model, opt = state["model"], state["opt"]
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in
             enumerate(opt.state[p] for p in model.parameters())}, state["step"])


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
@pytest.mark.parametrize("fault", ["nan_loss", "inf_in_one_gradient"])
def test_nonfinite_step_leaves_params_moments_and_count_unchanged(fault, grad_clip):
    model = _model()
    state = {"model": model, "opt": ttrain.make_optimizer(model, 1e-3), "step": 0}
    grad_fn, apply_fn = ttrain.step_fns(CFG, lambda s: 1e-3, grad_clip)
    if fault == "nan_loss":
        bad_grad_fn, _ = ttrain.step_fns(
            CFG, lambda s: 1e-3, grad_clip, loss=lambda m, t: tl.loss_fn(m, t) * float("nan"))
    else:
        def bad_grad_fn(state, tokens):
            loss, grads = grad_fn(state, tokens)
            next(g for g in grads if g.dim() == 2)[1, 2] = float("inf")
            return loss, grads
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 64, size=(2, 17)))
    good, bad = make_guarded_step(grad_fn, apply_fn), make_guarded_step(bad_grad_fn, apply_fn)
    state, _, ok = good(state, tokens)
    assert ok and state["step"] == 1
    params, moments, count = _snapshot(state)
    state, loss, ok = bad(state, tokens)
    assert not ok
    after_params, after_moments, after_count = _snapshot(state)
    assert after_count == count == 1
    for name, p in params.items():
        assert torch.equal(after_params[name], p), name
        assert model.get_parameter(name).grad is None
    for i, m in moments.items():
        for k, v in m.items():
            assert torch.equal(after_moments[i][k], v), (i, k)   # exp_avg, exp_avg_sq, step
    state, _, ok = good(state, tokens)         # the dropped gradients left no trace
    assert ok and state["step"] == 2 and all(
        torch.isfinite(p).all() for p in model.parameters())


def test_devices_healthy_probes_every_cuda_device_in_a_subprocess():
    assert devices_healthy(timeout_s=120) == torch.cuda.is_available()


def test_new_modules_never_import_jax(tmp_path):
    code = (
        "import sys, numpy as np, os\n"
        "import fa2_triton_tpu_torch.utils.data, fa2_triton_tpu_torch.utils.checkpoint\n"
        "import fa2_triton_tpu_torch.utils.resilience, fa2_triton_tpu_torch.utils.profiling\n"
        "import fa2_triton_tpu_torch.utils.benchmarking, fa2_triton_tpu_torch.runtime.serving_demo\n"
        "from fa2_triton_tpu_torch.examples import eval as ev, train\n"
        f"d = {str(tmp_path)!r}\n"
        "c = os.path.join(d, 'c.bin')\n"
        "fa2_triton_tpu_torch.utils.data.encode_corpus(np.arange(200) % 64, c, 32000)\n"
        "a = ['--device', 'cpu', '--dim', '64', '--layers', '1', '--seq', '17', '--batch', '2']\n"
        "train.main(a + ['--steps', '2', '--data', c, '--ckpt-dir', d])\n"
        "ev.main(['--device', 'cpu', '--dim', '64', '--layers', '1', '--seq', '16', '--batch', '2',\n"
        "         '--batches', '1', '--data', c, '--ckpt-dir', d])\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'fa2_triton_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
