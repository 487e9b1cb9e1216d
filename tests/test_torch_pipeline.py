"""The port's pipeline parallelism (`fa2_triton_tpu_torch/parallel/
pipeline.py`) against the JAX package's (`fa2_triton_tpu/parallel/
pipeline.py`) on the CPU.

The port's cases run on one spawned world of 8 gloo CPU ranks, once for
the module, while the JAX references are computed on the conftest's 8
virtual devices (JAX's own functions under `jax.jit`, as
`tests/test_pipeline.py` runs them). Inputs come from numpy seeds; the
LLaMA weights are a JAX `init_params` tree converted with
`models/convert.py`. fp32 throughout. Tolerances, as `test_pipeline.py`
holds JAX's own:

* a generic pipeline of 8 tanh layers over 4 stages x 3 microbatches:
  against JAX's `make_pipeline`, 1e-6;
* the LLaMA pipeline forward at (pipe 2, M 2) and (pipe 4, M 3): against
  JAX's pipeline logits, 2e-4;
* the pipeline's loss and every gradient at (pipe 2, M 2): against JAX's
  single-device `value_and_grad(loss_fn)`, loss rtol 1e-5, gradients atol
  1e-4, rtol 1e-3;
* pp 2 x dp 2 x tp 2 (`make_llama_3d_forward`): logits against JAX's 3-D
  forward, 2e-4; gradients of mean(log_softmax(logits) ** 2) against JAX's
  single-device gradient of the same loss (JAX's own 3-D test only asks
  for finite gradients), atol 1e-4, rtol 1e-3.
"""
import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fa2_triton_tpu.models import llama as jl  # noqa: E402
from fa2_triton_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from fa2_triton_tpu.parallel import pipeline as jpl  # noqa: E402
from fa2_triton_tpu_torch.parallel import spawn_ranks  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_train_ranks as ptr  # noqa: E402

CFG = dict(vocab_size=128, dim=64, n_layers=4, n_heads=4, n_kv_heads=2, hidden_dim=96,
           max_seq_len=64)
J_CFG = jl.LlamaConfig(dtype=jnp.float32, **CFG)
L, D, M_GEN, MB = 8, 16, 3, 4
LLAMA_CASES = {(2, 2): (4, 32, 1), (4, 3): (6, 32, 2)}    # (pipe, M): (B, S, seed)


def _inputs():
    rs = np.random.RandomState(0)
    ws = (rs.randn(L, D, D) / np.sqrt(D)).astype(np.float32)
    xs = rs.randn(M_GEN, MB, D).astype(np.float32)
    trees = {seed: jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(seed), J_CFG))
             for seed in (0, 2, 4)}
    toks = {key: np.random.RandomState(seed).randint(0, CFG["vocab_size"], size=(B, S))
            for key, (B, S, seed) in LLAMA_CASES.items()}
    toks["grad"] = np.random.RandomState(3).randint(0, CFG["vocab_size"], size=(4, 24))
    toks["3d"] = np.random.RandomState(5).randint(0, CFG["vocab_size"], size=(8, 32))
    return ws, xs, trees, toks


def _cases(ws, xs, trees, toks):
    out = {"generic": dict(kind="generic", mesh={"pipe": 4, "data": 2}, ws=ws, xs=xs, M=M_GEN)}
    for (pipe, M) in LLAMA_CASES:
        out[f"llama_{pipe}_{M}"] = dict(kind="llama", mesh={"pipe": pipe, "data": 8 // pipe},
                                        tree=trees[0], cfg=CFG, tokens=toks[pipe, M], M=M)
    out["grad"] = dict(kind="llama_grad", mesh={"pipe": 2, "data": 4}, tree=trees[2], cfg=CFG,
                       tokens=toks["grad"], M=2)
    out["3d"] = dict(kind="3d", mesh={"pipe": 2, "data": 2, "model": 2}, tree=trees[4], cfg=CFG,
                     tokens=toks["3d"], M=2)
    return out


def _jax_refs(ws, xs, trees, toks):
    refs = {}
    mesh = jax_mesh(pipe=4)

    def stage_fn(local, x):
        return jax.lax.scan(lambda x, layer: (jnp.tanh(x @ layer["w"]), None), x, local)[0]

    stacked = jpl.stack_layer_params([{"w": jnp.asarray(w)} for w in ws])
    with mesh:
        refs["generic"] = np.asarray(jax.jit(jpl.make_pipeline(mesh, stage_fn, M_GEN))(
            stacked, jnp.asarray(xs)))
    params = trees[0]
    for (pipe, M) in LLAMA_CASES:
        pmesh = jax_mesh(pipe=pipe)
        pf = jpl.make_llama_pipeline_forward(pmesh, J_CFG, n_microbatches=M)
        with pmesh:
            refs[f"llama_{pipe}_{M}"] = np.asarray(jax.jit(pf)(
                jpl.pipeline_params_from_llama(params, pmesh), jnp.asarray(toks[pipe, M])))
    loss, grads = jax.jit(jax.value_and_grad(jl.loss_fn), static_argnums=2)(
        trees[2], jnp.asarray(toks["grad"]), J_CFG)
    refs["grad"] = (float(loss), jax.tree.map(np.asarray, grads))
    mesh3 = jax_mesh(pipe=2, data=2, model=2)
    f3d = jpl.make_llama_3d_forward(mesh3, J_CFG, n_microbatches=2)
    with mesh3:
        refs["3d_logits"] = np.asarray(jax.jit(f3d)(
            jpl.pipeline_params_from_llama(trees[4], mesh3, tp=True), jnp.asarray(toks["3d"])))

    def loss3(p):
        return jnp.mean(jax.nn.log_softmax(jl.forward(p, jnp.asarray(toks["3d"]), J_CFG)) ** 2)

    refs["3d_grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(loss3))(trees[4]))
    return refs


@pytest.fixture(scope="module")
def runs():
    ws, xs, trees, toks = _inputs()
    cases = _cases(ws, xs, trees, toks)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_ranks, ptr.pipeline_rank, 8, (list(cases.values()),),
                           timeout_s=300)
        refs = _jax_refs(ws, xs, trees, toks)
        ranks = port.result()
    return {name: [r[i] for r in ranks] for i, name in enumerate(cases)}, refs, cases


def _jax_grad(tree, name):
    """The leaf of a JAX gradient tree named as the port names it."""
    parts = name.split(".")
    node = tree
    for p in parts:
        node = node[int(p)] if p.isdigit() else node[p]
    return node


def _stage_owner(name, pipe):
    """The pipe stage holding a layer parameter (None for top-level ones)."""
    if not name.startswith("layers."):
        return None
    return int(name.split(".")[1]) // (CFG["n_layers"] // pipe)


def test_generic_pipeline_matches_jax(runs):
    got, refs, _ = runs
    for r in got["generic"]:
        np.testing.assert_allclose(r["ys"], refs["generic"], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pipe,M", list(LLAMA_CASES))
def test_llama_pipeline_matches_jax(runs, pipe, M):
    got, refs, _ = runs
    for r in got[f"llama_{pipe}_{M}"]:
        np.testing.assert_allclose(r["logits"], refs[f"llama_{pipe}_{M}"], atol=2e-4, rtol=2e-4)


def test_pipeline_loss_and_gradients_match_single_device(runs):
    got, refs, cases = runs
    loss, grads = refs["grad"]
    ranks = got["grad"]
    data = cases["grad"]["mesh"]["data"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
    names = list(ranks[0]["grads"])
    assert len(names) == 3 + 9 * CFG["n_layers"]
    for name in names:
        owner = _stage_owner(name, 2)
        g = ranks[0 if owner is None else owner * data]["grads"][name]
        np.testing.assert_allclose(g, _jax_grad(grads, name), atol=1e-4, rtol=1e-3, err_msg=name)


def test_3d_logits_match_jax(runs):
    got, refs, _ = runs
    for r in got["3d"]:
        np.testing.assert_allclose(r["logits"], refs["3d_logits"], atol=2e-4, rtol=2e-4)


def test_3d_gradients_match_single_device(runs):
    """Rank (p, d, m) = p * 4 + d * 2 + m. A stage's Megatron-cut leaves are
    the sum of its two model ranks' pieces (zeros outside each piece); its
    norms are whole on both; data ranks hold equal gradients (f over
    `data`)."""
    got, refs, _ = runs
    ranks = got["3d"]
    for name in ranks[0]["grads"]:
        owner = _stage_owner(name, 2)
        if owner is None:
            g = ranks[0]["grads"][name]
            for r in ranks[1:]:
                np.testing.assert_allclose(r["grads"][name], g, atol=1e-6, rtol=1e-6)
        elif name.endswith("norm"):
            g = ranks[owner * 4]["grads"][name]
        else:
            g = ranks[owner * 4]["grads"][name] + ranks[owner * 4 + 1]["grads"][name]
            np.testing.assert_allclose(ranks[owner * 4 + 2]["grads"][name]
                                       + ranks[owner * 4 + 3]["grads"][name], g,
                                       atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g, _jax_grad(refs["3d_grads"], name), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
