"""The port's training slice against the JAX package on the same weights:
`loss_fn` and every parameter gradient (a JAX `init_params` tree converted
with `llama_from_jax_params`, gradients mapped back with
`llama_to_jax_params`), remat, one clipped AdamW step of the trainer
against `optax.chain(clip_by_global_norm, adamw)`, and the LR schedule.
fp32, 2 layers, narrow widths, GQA.

Tolerances: loss 1e-5 and gradients 1e-5 max abs (fp32 on both sides, only
summation order and transcendental rounding differ; the gradients here are
at most ~0.1). The optimizer step is fed the JAX gradients, so parameters
after it agree to 2.5e-7 max abs (two fp32 ulps at the norm weights'
magnitude 1, where the update at lr 1e-3 is rounded):
with the port's own gradients, Adam's first step lr * g / (|g| + eps)
would turn the rounding noise of a gradient near 0 into a step of up to lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from fa2_triton_tpu.models import llama as jl

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.examples import train as ttrain  # noqa: E402
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import (  # noqa: E402
    jax_path, llama_from_jax_params, llama_to_jax_params)

TOL = 1e-5
J_CFG = jl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=256, rope_theta=10000.0, dtype=jnp.float32)
T_CFG = tl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=256, rope_theta=10000.0, dtype=torch.float32)


@pytest.fixture(scope="module")
def setup():
    params = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tokens = np.random.RandomState(0).randint(0, 128, size=(2, 41)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(jl.loss_fn)(params, jnp.asarray(tokens), J_CFG)
    return params, tokens, float(j_loss), jax.tree.map(np.asarray, j_grads)


def _model(params, **cfg_over):
    import dataclasses

    return llama_from_jax_params(jax.tree.map(np.asarray, params),
                                 dataclasses.replace(T_CFG, **cfg_over), device="cpu")


def _assert_trees_close(t_tree, j_tree, atol):
    leaves_t = jax.tree_util.tree_leaves_with_path(t_tree)
    leaves_j = dict(jax.tree_util.tree_leaves_with_path(j_tree))
    assert len(leaves_t) == len(leaves_j)
    for path, a in leaves_t:
        np.testing.assert_allclose(a, leaves_j[path], rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_loss_and_every_gradient_match_jax(setup):
    params, tokens, j_loss, j_grads = setup
    model = _model(params)
    loss = tl.loss_fn(model, torch.from_numpy(tokens).long())
    loss.backward()
    assert abs(loss.item() - j_loss) <= TOL
    _assert_trees_close(llama_to_jax_params(model, grads=True), j_grads, TOL)


def test_remat_gives_the_same_gradients(setup):
    params, tokens, _, _ = setup
    grads = []
    for remat in (False, True):
        model = _model(params, remat=remat)
        tl.loss_fn(model, torch.from_numpy(tokens).long()).backward()
        grads.append(dict((n, p.grad) for n, p in model.named_parameters()))
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0, msg=name)


def test_one_clipped_adamw_step_matches_optax(setup):
    params, tokens, _, j_grads = setup
    lr, clip = 1e-3, 0.05
    opt = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(lr, weight_decay=0.01))
    updates, _ = opt.update(jax.tree.map(jnp.asarray, j_grads), opt.init(params), params)
    j_new = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    assert float(optax.global_norm(j_grads)) > clip  # the clip really acts

    model = _model(params)
    for name, p in model.named_parameters():
        leaf = j_grads
        for key in jax_path(name):
            leaf = leaf[key]
        p.grad = torch.from_numpy(np.array(leaf))
    ttrain.optimizer_step(model, ttrain.make_optimizer(model, lr), lr, clip)
    _assert_trees_close(llama_to_jax_params(model), j_new, 2.5e-7)


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    steps, peak = 10, 3e-4
    sched = (optax.warmup_cosine_decay_schedule(0.0, peak, warmup, max(steps, warmup + 1),
                                                end_value=peak / 10)
             if warmup else optax.constant_schedule(peak))
    for step in range(steps + 2):
        assert abs(ttrain.lr_at(step, peak, steps, warmup) - float(sched(step))) <= 1e-9


def test_jax_path_names():
    assert jax_path("layers.3.wq") == ("layers", 3, "wq")
    assert jax_path("final_norm") == ("final_norm",)


def test_trainer_runs_on_the_cpu_and_the_loss_falls():
    res = ttrain.run(ttrain.parse_args(
        ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "17", "--dim", "64",
         "--layers", "2", "--remat", "--repeat-batch", "--lr", "3e-3"]))
    assert len(res["losses"]) == 4 and np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]
    assert res["tokens_per_step"] == 2 * 16


@pytest.mark.parametrize("argv", [["--dp", "2"], ["--tp", "2"], ["--fsdp"], ["--moe", "4"],
                                  ["--data", "corpus.bin"], ["--ckpt-dir", "ckpt"]])
def test_trainer_flags_not_ported_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttrain.parse_args(argv)
