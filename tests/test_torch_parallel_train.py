"""The port's training over a mesh (`parallel/fsdp.py`, `models/llama.py`'s
`tp_group`, `models/moe.py:make_ep_mlp` / `moe_param_pspecs`, the guarded
step of `utils/resilience.py` over a mesh) against the JAX package on the
CPU.

The port's cases run on one spawned world of 4 gloo CPU ranks, once for
the module, while the JAX references are computed on the conftest's 8
virtual devices. Weights are JAX `init_params` trees converted with
`models/convert.py`, tokens come from numpy seeds, fp32 throughout.

* TP training (`loss_fn` with `tp_group`, Megatron's f and g, the
  vocab-parallel head) at model 2 (on a data 2 x model 2 world whose two
  data ranks each take the whole batch: two replicas of the model-2 step)
  and at data 2 x model 2 with the rows cut over data: the loss and
  every gradient, its pieces gathered, against JAX's single-device
  `value_and_grad(loss_fn)`: loss rtol 1e-5, gradients atol 2e-5, rtol
  1e-4.
* FSDP (data 4) and FSDP + TP (data 2 x model 2), `tests/test_fsdp.py`'s
  cases: one AdamW(1e-3) step against JAX's jitted step: loss rtol 1e-6 /
  1e-5, parameters atol 2e-5, rtol 1e-4; the specs equal JAX's
  `fsdp_param_pspecs`, and each rank's piece of every cut leaf, and each
  of its two moments, is 1 / dp of the leaf's TP shard.
* MoE over data ranks that each hold their rows (the trainer's
  `model_loss`): plain DP at data 4, and EP + FSDP at data 2 x model 2,
  capacity factor 0.75 so that tokens drop: the loss and every gradient
  against JAX's single-device `moe.loss_fn` on the whole batch (one
  capacity, one slot order, one aux loss), loss rtol 1e-5, gradients atol
  2e-5, rtol 1e-4; routing each rank's rows alone gives another loss.
* EP: `make_ep_mlp` at model 4 (8 experts, top 2) against JAX's on its
  virtual mesh, out and aux atol / rtol 1e-5; an EP MoE step (attention TP
  on the same axis) against JAX's single-device `moe.loss_fn`, loss rtol
  1e-5, gradients atol 2e-5, rtol 1e-4; `moe_param_pspecs` equal to JAX's
  table leaf by leaf.
* The guarded step over 2 data ranks (x model 2, FSDP): only data rank 1
  sees a NaN gradient, every rank skips, and the state stays bit for bit;
  the clipped step's global norm equals one rank's `clip_grad_norm_` of
  the whole model's gradient to 1e-6 relative.
"""
import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fa2_triton_tpu.models import llama as jl  # noqa: E402
from fa2_triton_tpu.models import moe as jmoe  # noqa: E402
from fa2_triton_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from fa2_triton_tpu.parallel import mesh as jm  # noqa: E402
from fa2_triton_tpu_torch.models import MoEConfig  # noqa: E402
from fa2_triton_tpu_torch.models import moe as tmoe  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.parallel import mesh as tm  # noqa: E402
from fa2_triton_tpu_torch.parallel import spawn_ranks  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_train_ranks as ptr  # noqa: E402

TP_CFG = dict(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=256,
              max_seq_len=256)
FSDP_CFG = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=256,
                max_seq_len=64)     # tests/test_fsdp.py's CFG
MOE_CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=96,
               max_seq_len=64, n_experts=4, top_k=2)
EP4_CFG = dict(MOE_CFG, n_experts=8)
MOE_DP_CFG = dict(MOE_CFG, capacity_factor=0.75)
MESHES = {"tp_model2_whole_batch_per_data_rank": {"data": 2, "model": 2},
          "tp_data2_model2": {"data": 2, "model": 2},
          "fsdp_data4": {"data": 4}, "fsdp_data2_model2": {"data": 2, "model": 2}}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_named(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)] = leaf
    return out


def _inputs():
    tp_tree = _np_tree(jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig(dtype=jnp.float32,
                                                                             **TP_CFG)))
    f_tree = _np_tree(jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig(dtype=jnp.float32,
                                                                            **FSDP_CFG)))
    moe_tree = _np_tree(jmoe.init_params(jax.random.PRNGKey(1),
                                         jmoe.MoEConfig(dtype=jnp.float32, **MOE_CFG)))
    ep4_tree = _np_tree(jmoe.init_params(jax.random.PRNGKey(2),
                                         jmoe.MoEConfig(dtype=jnp.float32, **EP4_CFG)))
    rs = np.random.RandomState(0)
    return {"tp_tree": tp_tree, "f_tree": f_tree, "moe_tree": moe_tree, "ep4_tree": ep4_tree,
            "tp_tokens": rs.randint(0, 128, size=(4, 41)),
            "f_tokens": rs.randint(0, 256, size=(8, 33)),
            "moe_tokens": rs.randint(0, 128, size=(2, 33)),
            "moe_dp_tokens": rs.randint(0, 128, size=(4, 33)),
            "ep_x": (rs.randn(2, 32, 64) * 0.5).astype(np.float32),
            "guard_tokens": rs.randint(0, 256, size=(4, 17))}


def _cases(inp):
    return {
        "tp_model2_whole_batch_per_data_rank": dict(
            kind="tp", mesh=MESHES["tp_model2_whole_batch_per_data_rank"], tree=inp["tp_tree"],
            cfg=TP_CFG, tokens=inp["tp_tokens"]),
        "tp_data2_model2": dict(kind="tp", mesh=MESHES["tp_data2_model2"], tree=inp["tp_tree"],
                                cfg=TP_CFG, tokens=inp["tp_tokens"], rows=True),
        "fsdp_data4": dict(kind="fsdp", mesh=MESHES["fsdp_data4"], tree=inp["f_tree"], cfg=FSDP_CFG,
                           tokens=inp["f_tokens"], rows=True),
        "fsdp_data2_model2": dict(kind="fsdp", mesh=MESHES["fsdp_data2_model2"], tree=inp["f_tree"],
                                  cfg=FSDP_CFG, tokens=inp["f_tokens"], rows=True),
        "ep_mlp": dict(kind="ep_mlp", mesh={"model": 4}, tree=inp["ep4_tree"], cfg=EP4_CFG,
                       x=inp["ep_x"]),
        "ep_train": dict(kind="ep_train", mesh={"data": 2, "model": 2}, tree=inp["moe_tree"],
                         cfg=MOE_CFG, tokens=inp["moe_tokens"]),
        "moe_data4": dict(kind="moe_dp", mesh={"data": 4}, tree=inp["moe_tree"],
                          cfg=MOE_DP_CFG, tokens=inp["moe_dp_tokens"], rows=True),
        "moe_data2_model2_fsdp": dict(kind="moe_dp", mesh={"data": 2, "model": 2},
                                      tree=inp["moe_tree"], cfg=MOE_DP_CFG,
                                      tokens=inp["moe_dp_tokens"], rows=True, fsdp=True),
        "guard": dict(kind="guard", mesh={"data": 2, "model": 2}, tree=inp["f_tree"], cfg=FSDP_CFG,
                      tokens=inp["guard_tokens"], rows=True),
    }


def _jax_refs(inp):
    refs = {}
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **TP_CFG)
    loss, grads = jax.jit(jax.value_and_grad(jl.loss_fn), static_argnums=2)(
        inp["tp_tree"], jnp.asarray(inp["tp_tokens"]), jcfg)
    refs["tp"] = (float(loss), _jax_named(_np_tree(grads)))

    fcfg = jl.LlamaConfig(dtype=jnp.float32, **FSDP_CFG)
    opt = optax.adamw(1e-3)

    def step(params, tokens):
        loss, g = jax.value_and_grad(lambda p: jl.loss_fn(p, tokens, fcfg))(params)
        updates, _ = opt.update(g, opt.init(params), params)
        return optax.apply_updates(params, updates), loss

    new, loss = jax.jit(step)(inp["f_tree"], jnp.asarray(inp["f_tokens"]))
    refs["fsdp"] = (float(loss), _jax_named(_np_tree(new)))
    for name in ("fsdp_data4", "fsdp_data2_model2"):
        refs[name, "specs"] = {k: tuple(v) for k, v in _jax_named(
            jm.fsdp_param_pspecs(inp["f_tree"], jax_mesh(**MESHES[name]))).items()}

    ecfg = jmoe.MoEConfig(dtype=jnp.float32, **EP4_CFG)
    emesh = jax_mesh(model=4)
    layer = jax.tree.map(jnp.asarray, inp["ep4_tree"]["layers"][0])
    with emesh:
        out, aux = jax.jit(lambda l, x: jmoe.make_ep_mlp(emesh)(l, x, ecfg))(
            layer, jnp.asarray(inp["ep_x"]))
    refs["ep_mlp"] = (np.asarray(out), float(aux))

    mcfg = jmoe.MoEConfig(dtype=jnp.float32, **MOE_CFG)
    loss, grads = jax.jit(jax.value_and_grad(jmoe.loss_fn), static_argnums=2)(
        inp["moe_tree"], jnp.asarray(inp["moe_tokens"]), mcfg)
    refs["ep_train"] = (float(loss), _jax_named(_np_tree(grads)))

    dcfg = jmoe.MoEConfig(dtype=jnp.float32, **MOE_DP_CFG)
    loss, grads = jax.jit(jax.value_and_grad(jmoe.loss_fn), static_argnums=2)(
        inp["moe_tree"], jnp.asarray(inp["moe_dp_tokens"]), dcfg)
    refs["moe_dp"] = (float(loss), _jax_named(_np_tree(grads)))
    return refs


@pytest.fixture(scope="module")
def runs():
    inp = _inputs()
    cases = _cases(inp)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_ranks, ptr.train_rank, 4, (list(cases.values()),), timeout_s=300)
        refs = _jax_refs(inp)
        ranks = port.result()
    return {name: [r[i] for r in ranks] for i, name in enumerate(cases)}, refs, inp


def _whole(ranks, name, spec):
    """A parameter (or gradient) from its pieces: along each cut axis the
    pieces of ranks that differ only there, concatenated in rank order."""
    def piece(data, model):
        r = next(r for r in ranks if r["coords"]["data"] == data and r["coords"]["model"] == model)
        return r[name]

    dp = 1 + max(r["coords"]["data"] for r in ranks)
    tp = 1 + max(r["coords"]["model"] for r in ranks)
    d_dim = spec.index("data") if "data" in spec and dp > 1 else None
    m_dim = spec.index("model") if "model" in spec and tp > 1 else None
    rows = []
    for d in range(dp if d_dim is not None else 1):
        cols = [piece(d, m) for m in range(tp if m_dim is not None else 1)]
        rows.append(np.concatenate(cols, axis=m_dim) if m_dim is not None else cols[0])
    return np.concatenate(rows, axis=d_dim) if d_dim is not None else rows[0]


def _gathered(ranks, key):
    specs = ranks[0]["specs"]
    names = list(ranks[0][key])
    out = {}
    for n in names:
        flat = [{"coords": r["coords"], n: r[key][n]} for r in ranks]
        out[n] = _whole(flat, n, specs.get(n, ()))
    return out


@pytest.mark.parametrize("case", ["tp_model2_whole_batch_per_data_rank", "tp_data2_model2"])
def test_tp_training_loss_and_gradients_match_jax(runs, case):
    got, refs, _ = runs
    loss, grads = refs["tp"]
    ranks = got[case]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
    whole = _gathered(ranks, "grads")
    assert set(whole) == set(grads)
    for n, g in whole.items():
        np.testing.assert_allclose(g, grads[n], atol=2e-5, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("case,loss_rtol", [("fsdp_data4", 1e-6), ("fsdp_data2_model2", 1e-5)])
def test_fsdp_step_matches_jax(runs, case, loss_rtol):
    got, refs, _ = runs
    loss, params = refs["fsdp"]
    ranks = got[case]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=loss_rtol)
    whole = _gathered(ranks, "params")
    for n, p in whole.items():
        np.testing.assert_allclose(p, params[n], atol=2e-5, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("case", ["fsdp_data4", "fsdp_data2_model2"])
def test_fsdp_specs_and_bytes(runs, case):
    """The specs equal JAX's, with `tests/test_fsdp.py`'s assertions; each
    rank keeps 1 / dp of every cut leaf's TP shard, and so do its moments."""
    got, refs, inp = runs
    ranks = got[case]
    specs = ranks[0]["specs"]
    assert specs == refs[case, "specs"]
    if case == "fsdp_data4":
        assert specs["layers.0.wq"] != () and specs["layers.0.attn_norm"] == ()
    else:
        assert specs["layers.0.wq"] == ("data", "model")
        assert specs["layers.0.wo"] == ("model", "data")
        assert specs["layers.0.w_down"] == ("model", "data")
        assert specs["embed"] == ("data", None)
        assert specs["layers.0.attn_norm"] == ()
    full = _jax_named(inp["f_tree"])
    dp, tp = MESHES[case]["data"], MESHES[case].get("model", 1)
    cut = [n for n, s in specs.items() if "data" in s]
    assert cut
    for r in ranks:
        for n in cut:
            tp_shard = full[n].size // (tp if "model" in specs[n] else 1)
            assert r["params"][n].size * dp == tp_shard, n
            assert r["moments"][n] == [r["params"][n].size] * 2, n


def test_ep_mlp_matches_jax(runs):
    got, refs, _ = runs
    out, aux = refs["ep_mlp"]
    for r in got["ep_mlp"]:
        np.testing.assert_allclose(r["out"], out, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["aux"], aux, atol=1e-5, rtol=1e-5)


def test_ep_training_step_matches_jax(runs):
    got, refs, _ = runs
    loss, grads = refs["ep_train"]
    ranks = got["ep_train"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert r["specs"] == ranks[0]["specs"]
    pieces = [{"coords": {"data": 0, "model": r["model"]}, **r["grads"]} for r in ranks[:2]]
    for n in ranks[0]["grads"]:
        g = _whole([{"coords": p["coords"], n: p[n]} for p in pieces], n, ranks[0]["specs"][n])
        np.testing.assert_allclose(g, grads[n], atol=2e-5, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("case", ["moe_data4", "moe_data2_model2_fsdp"])
def test_moe_over_data_ranks_routes_the_whole_batch(runs, case):
    """Each data rank holds its rows, yet the capacity, the slots and the
    aux loss are the whole batch's: loss and gradients equal JAX's one
    device on the whole batch, where routing each rank's rows alone does
    not."""
    got, refs, _ = runs
    loss, grads = refs["moe_dp"]
    ranks = got[case]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert abs(r["rank_alone"] - loss) > 1e-3, (r["rank_alone"], loss)
    whole = _gathered(ranks, "grads")
    assert set(whole) == set(grads)
    for n, g in whole.items():
        np.testing.assert_allclose(g, grads[n], atol=2e-5, rtol=1e-4, err_msg=n)


def test_moe_param_pspecs_equal_jax(runs):
    _, _, inp = runs
    model = llama_from_jax_params(inp["moe_tree"], MoEConfig(dtype=torch.float32, **MOE_CFG),
                                  device="cpu")
    want = {k: tuple(v) for k, v in _jax_named(jmoe.moe_param_pspecs(inp["moe_tree"])).items()}
    assert tmoe.moe_param_pspecs(model) == want
    assert tm.param_pspecs(model)["layers.0.we_gate"] == ()   # the dense table leaves experts


def test_guarded_step_over_the_mesh(runs):
    got, _, _ = runs
    for r in got["guard"]:
        assert r["ok"] is False and r["skipped"] == 1 and r["unchanged"], r
        assert r["ok2"] is True and r["step"] == 1
        np.testing.assert_allclose(r["norm"], r["ref_norm"], rtol=1e-6)
