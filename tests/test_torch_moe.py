"""The port's Mixtral-style MoE family (`models/moe.py`) against the JAX
package's on the same weights: a JAX `moe.init_params` tree converted with
`llama_from_jax_params` into an `MoEConfig` model.

The JAX suite's MoE config (vocab 128, dim 64, 2 layers, 4 / 2 heads,
hidden 96, 4 experts, top-2), fp32. Routing (the expert indices) and the
slot of every (token, choice) must be equal bit for bit; values within
1e-5 (sums of <= 96 fp32 products taken in another order: JAX contracts
one-hot [T, E, C] tensors, the port gathers and scatters rows), logits
within 1e-4 and gradients within 1e-5 as in `test_torch_llama.py` /
`test_torch_train.py`. The Engine's greedy tokens must equal JAX's with
log-probs within 1e-4, each top-1 margin above 10x that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.models import moe as jm
from fa2_triton_tpu.runtime import Engine as JaxEngine

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.examples import train as ttrain  # noqa: E402
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models import moe as tm  # noqa: E402
from fa2_triton_tpu_torch.models.convert import (  # noqa: E402
    llama_from_jax_params, llama_to_jax_params,
)
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402

TOL, LOGIT_TOL, LP_TOL = 1e-5, 1e-4, 1e-4
KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=96,
          max_seq_len=512, n_experts=4, top_k=2)
J_CFG = jm.MoEConfig(dtype=jnp.float32, **KW)
T_CFG = tm.MoEConfig(dtype=torch.float32, **KW)
B, S = 2, 32
T = B * S
CAPACITIES = (None, 8, 1)     # default (40 here), then drops, then capacity 1


@pytest.fixture(scope="module")
def setup():
    """JAX params, the port model, a block input, and every JAX value the
    tests compare against, computed once."""
    jp = jm.init_params(jax.random.PRNGKey(0), J_CFG)
    model = llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (B, S, 64), jnp.float32) * 0.5)
    layer = jp["layers"][0]
    h = jl.rms_norm(jnp.asarray(x), layer["mlp_norm"], J_CFG.norm_eps).reshape(T, 64)
    ref = {"h": np.asarray(h), "route": [np.asarray(a) for a in jm._route(h, layer["router"], J_CFG)]}
    for c in CAPACITIES:
        C = jm._capacity(J_CFG, T) if c is None else c
        disp = np.asarray(jm._dispatch_tensors(h, layer, J_CFG, C)[0])
        ref["disp", c] = disp
        ref["mlp", c] = [np.asarray(a) for a in jm.moe_mlp(layer, jnp.asarray(x), J_CFG, c)]
    ref["mlp", T] = [np.asarray(a) for a in jm.moe_mlp(layer, jnp.asarray(x), J_CFG, T)]
    ref["dense"] = [np.asarray(a) for a in jm.moe_mlp_dense(layer, jnp.asarray(x), J_CFG)]
    tokens = np.random.RandomState(0).randint(0, 128, size=(B, 33))
    ref["tokens"] = tokens
    ref["forward"] = [np.asarray(a) for a in jax.jit(
        lambda p, t: jm.forward(p, t, J_CFG, return_aux=True))(jp, jnp.asarray(tokens[:, :-1]))]
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t: jm.loss_fn(p, t, J_CFG)))(
        jp, jnp.asarray(tokens, jnp.int32))
    ref["loss"], ref["grads"] = float(loss), jax.tree.map(np.asarray, grads)
    return jp, model, x, ref


def test_conversion_is_a_copy_and_plain_configs_refuse_router_trees(setup):
    jp, model, _, _ = setup
    layer = model.layers[1]
    assert layer.router.dtype == torch.float32 and layer.w_gate is None
    for key in ("router", "we_gate", "we_up", "we_down"):
        np.testing.assert_array_equal(getattr(layer, key).detach().numpy(),
                                      np.asarray(jp["layers"][1][key]))
    tree = llama_to_jax_params(model)
    assert sorted(tree["layers"][0]) == sorted(jp["layers"][0])
    plain = tl.LlamaConfig(**{k: v for k, v in KW.items() if k not in ("n_experts", "top_k")},
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="MoEConfig"):
        llama_from_jax_params(jax.tree.map(np.asarray, jp), plain, device="cpu")


def test_route_capacity_and_aux_match_jax(setup):
    _, model, _, ref = setup
    h = torch.tensor(ref["h"])
    weights, idx, probs = tm._route(h, model.layers[0].router, T_CFG)
    np.testing.assert_array_equal(idx.numpy(), ref["route"][1])
    np.testing.assert_allclose(weights.detach().numpy(), ref["route"][0], rtol=0, atol=TOL)
    np.testing.assert_allclose(probs.detach().numpy(), ref["route"][2], rtol=0, atol=TOL)
    for n in (1, 7, 64, 4094):
        assert tm._capacity(T_CFG, n) == jm._capacity(J_CFG, n)
    j_aux = float(jm._aux_loss(jnp.asarray(ref["route"][2]), jnp.asarray(ref["route"][1]), J_CFG))
    np.testing.assert_allclose(float(tm._aux_loss(probs, idx, T_CFG).detach()), j_aux, rtol=1e-6)
    uniform = torch.full((64, 4), 0.25)
    round_robin = torch.stack([torch.arange(64) % 4, (torch.arange(64) + 1) % 4], dim=1)
    assert abs(float(tm._aux_loss(uniform, round_robin, T_CFG)) - 1.0) < 1e-6


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_slots_equal_jax_dispatch(setup, capacity):
    """Every (token, choice): kept or dropped, and its slot, equal to the
    argmax of JAX's one-hot dispatch tensor, bit for bit."""
    _, _, _, ref = setup
    C = jm._capacity(J_CFG, T) if capacity is None else capacity
    idx = torch.tensor(ref["route"][1]).long()
    experts, pos, keep = tm._slots(idx, 4, C)
    disp = ref["disp", capacity]                                   # [T, E, C]
    j_idx = ref["route"][1].T.reshape(-1)                          # j-major
    tok = np.tile(np.arange(T), 2)
    rows = disp[tok, j_idx]                                        # [kT, C]
    np.testing.assert_array_equal(experts.numpy(), j_idx)
    np.testing.assert_array_equal(keep.numpy(), rows.sum(-1) > 0)
    np.testing.assert_array_equal(pos.numpy()[keep.numpy()], rows.argmax(-1)[keep.numpy()])
    if capacity is not None:
        assert not keep.all()


@pytest.mark.parametrize("capacity", CAPACITIES + (T,))
def test_moe_mlp_matches_jax(setup, capacity):
    _, model, x, ref = setup
    out, aux = tm.moe_mlp(model.layers[0], torch.from_numpy(x), T_CFG, capacity)
    np.testing.assert_allclose(out.detach().numpy(), ref["mlp", capacity][0], rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ref["mlp", capacity][1]), rtol=1e-6)
    if capacity == 1:   # a token whose choices all missed a slot keeps its residual exactly
        _, idx, _ = tm._route(torch.tensor(ref["h"]), model.layers[0].router, T_CFG)
        _, _, keep = tm._slots(idx, 4, 1)
        none = ~keep.view(2, T).any(dim=0)
        assert none.any()
        np.testing.assert_array_equal(out.detach().numpy().reshape(T, 64)[none.numpy()],
                                      x.reshape(T, 64)[none.numpy()])


def test_moe_mlp_dense_matches_jax_and_the_sparse_block(setup):
    _, model, x, ref = setup
    out, aux = tm.moe_mlp_dense(model.layers[0], torch.from_numpy(x), T_CFG)
    np.testing.assert_allclose(out.detach().numpy(), ref["dense"][0], rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ref["dense"][1]), rtol=1e-6)
    sparse, _ = tm.moe_mlp(model.layers[0], torch.from_numpy(x), T_CFG, capacity=T)
    np.testing.assert_allclose(sparse.detach().numpy(), out.detach().numpy(), rtol=0, atol=TOL)


def test_forward_with_aux_matches_jax(setup):
    _, model, _, ref = setup
    with torch.no_grad():
        logits, aux = tm.forward(model, torch.from_numpy(ref["tokens"][:, :-1]), return_aux=True)
    np.testing.assert_allclose(logits.numpy(), ref["forward"][0], rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(ref["forward"][1]), rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(setup, remat):
    """moe.loss_fn and the gradient of every leaf, the router's included
    (through the renormalized top-k weights and the aux loss), leaf by leaf
    through `llama_to_jax_params`; remat recomputes each layer."""
    jp, _, _, ref = setup
    cfg = tm.MoEConfig(dtype=torch.float32, remat=remat, **KW)
    model = llama_from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    loss = tm.loss_fn(model, torch.from_numpy(ref["tokens"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=0, atol=TOL)
    got = llama_to_jax_params(model, grads=True)
    for path, g in jax.tree_util.tree_leaves_with_path(ref["grads"]):
        leaf = got
        for p in path:
            leaf = leaf[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_allclose(leaf, g, rtol=0, atol=TOL, err_msg=jax.tree_util.keystr(path))
    assert np.abs(got["layers"][0]["router"]).max() > 0


def test_llama_paths_take_moe_layers(setup):
    """llama.forward (the dense block through `_mlp_block`) equals JAX's
    llama.forward on the MoE tree, and the cached forward of speculative
    decoding equals the port's full forward."""
    jp, model, _, ref = setup
    tokens = ref["tokens"][:1, :20]
    j = np.asarray(jax.jit(lambda p, t: jl.forward(p, t, J_CFG))(jp, jnp.asarray(tokens)))
    with torch.no_grad():
        full = tl.forward(model, torch.from_numpy(tokens))
        caches = tl.init_kv_cache(T_CFG, 1, 64, device="cpu")
        attn = tl.make_cached_attention_fn(T_CFG)
        a, _ = tl.forward_with_cache(model, torch.from_numpy(tokens[:, :15]), T_CFG, caches, 0, attn)
        b, _ = tl.forward_with_cache(model, torch.from_numpy(tokens[:, 15:]), T_CFG, caches, 15, attn)
    np.testing.assert_allclose(full.numpy(), j, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full.numpy(), rtol=0, atol=LOGIT_TOL)


@pytest.fixture(scope="module")
def served(setup):
    """JAX's Engine on the MoE tree: a 9- and an 11-token prompt (one
    batched prefill) and a 300-token one."""
    jp, _, _, _ = setup
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in (9, 11, 300)]
    eng = JaxEngine(jp, J_CFG, n_slots=2, max_seq=512)
    reqs = [eng.submit(p, 4) for p in prompts]
    eng.run()
    return prompts, reqs


@pytest.mark.parametrize("mode", [{}, {"paged": True, "page_size": 128},
                                  {"prefill_chunk": 128}])
def test_engine_serves_moe_like_jax(setup, served, mode):
    """Contiguous, paged and chunked (the 300-token prompt in 3 chunks)."""
    _, model, _, _ = setup
    prompts, j_reqs = served
    engine = Engine(model, T_CFG, n_slots=2, max_seq=512, **mode)
    reqs = [engine.submit(p, 4) for p in prompts]
    engine.run()
    for p, jr, r in zip(prompts, j_reqs, reqs):
        with torch.no_grad():
            logits = tl.forward(model, torch.tensor([p + r.out_tokens[:-1]]))[0, len(p) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 10 * LP_TOL
        assert r.out_tokens == jr.out_tokens
        np.testing.assert_allclose(r.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)


def test_trainer_moe_runs_on_the_cpu_and_the_loss_falls():
    args = ttrain.parse_args(["--device", "cpu", "--moe", "4", "--dim", "64", "--layers", "2",
                              "--seq", "17", "--batch", "2", "--steps", "4", "--lr", "1e-2",
                              "--repeat-batch"])
    res = ttrain.run(args)
    assert isinstance(res["config"], tm.MoEConfig) and res["config"].n_experts == 4
    assert np.isfinite(res["losses"]).all() and res["losses"][-1] < res["losses"][0]


def test_mixtral_preset_and_ep_not_ported(setup):
    cfg = ttrain.build_config(ttrain.parse_args(["--config", "mixtral-8x7b-v0.1", "--layers", "5",
                                                  "--remat"]))
    assert isinstance(cfg, tm.MoEConfig)
    assert (cfg.n_experts, cfg.top_k, cfg.router_aux_coef, cfg.capacity_factor) == (8, 2, 0.02, 1.25)
    assert (cfg.dim, cfg.hidden_dim, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) == (
        4096, 14336, 32, 8, 32000)
    assert cfg.n_layers == 5 and cfg.remat
    # Expert parallelism's table (not ported before the parallel trainer):
    # JAX's moe_param_pspecs, leaf by leaf, on this file's model.
    jp, model = setup[0], setup[1]
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(jm.moe_param_pspecs(jp))[0]:
        want[".".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)] = tuple(spec)
    got = tm.moe_param_pspecs(model)
    assert got == want
    assert got["layers.0.we_gate"] == ("model", None, None) and got["layers.0.router"] == (None, None)
    assert got["lm_head"] == () and got["layers.0.wo"] == ("model", None)
