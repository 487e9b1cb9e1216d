"""Head dims past 256 in the port against the JAX package, on the CPU.

JAX pads any head dim to a multiple of 128 and runs its Pallas kernels on
it (`tests/test_large_head_dim.py` pins D 384 and 512); the port's kernels
are built for D 384 and 512 besides 64 / 128 / 256, and the entry points
zero-pad any other D <= 512 to the next of them (D 300 -> 384). Here the
port runs its plain twins (CPU tensors) and JAX its kernels in interpret
mode, on the same numpy-seeded inputs:

* `flash_attn_func` forward and vjp at D 384 / 512, S 128 and 200 (200
  pads on the JAX side), causal and not, fp32, B 1, Hq 4 / Hkv 2: out within
  2e-5 and dq / dk / dv within 1e-4, JAX's own bounds; a dropout case (p
  0.1, the counter-hash mask bitwise on both sides) and a D 300 case;
* `pad_head_dim` / `kernel_head_dim`: the mapping, JAX's round-up to 128
  past 512 too, and the packed kernels' limit (CUDA tensors past 512
  raise, CPU tensors take any D);
* the routes: `backward_route` equals the route of JAX's real dispatch
  (the tri-square, the split and the work list among them: their kernels
  are built for D 384 / 512), and `forward_route` JAX's gates;
* a 2-layer model at head_dim 384 (dim 64, 2 / 1 heads): the JAX Engine and
  the port's serve the same prompts, contiguous and paged (greedy tokens
  equal, log-probs within 1e-4), and `loss_fn` and its gradients match
  (1e-5 / 1e-4).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.ops import flash_bwd as jb
from fa2_triton_tpu.ops import flash_fwd as jf
from fa2_triton_tpu.ops import tuning as jtuning
from fa2_triton_tpu.ops.tuning import choose_block_sizes
from fa2_triton_tpu.runtime import Engine as JaxEngine
from fa2_triton_tpu.utils import round_up_to_multiple

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd, varlen  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import (  # noqa: E402
    flash_attn_func, kernel_head_dim, pad_head_dim)
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402

OUT_TOL, GRAD_TOL = 2e-5, 1e-4
LP_TOL = 1e-4


def _inputs(S, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 0.5, (1, S, 4, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (1, S, 2, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (1, S, 2, D)).astype(np.float32)
    do = rng.normal(0, 0.5, (1, S, 4, D)).astype(np.float32)
    return q, k, v, do


def _both(q, k, v, do, **kw):
    """(out, dq, dk, dv) of JAX's flash_attn_func and the port's."""
    j_out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attn_func(q, k, v, **kw),
                         *(jnp.asarray(x) for x in (q, k, v)))
    j = [np.asarray(j_out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attn_func(*leaves, **kw)
    out.backward(torch.from_numpy(do))
    return j, [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("D,S,causal", [(384, 128, False), (384, 200, True), (512, 128, True),
                                        (512, 200, False)])
def test_flash_attn_func_forward_and_vjp_match_jax(D, S, causal):
    (j_out, *j_grads), (t_out, *t_grads) = _both(*_inputs(S, D, D + S), causal=causal)
    assert t_out.shape == (1, S, 4, D)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), j_grads, t_grads):
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("D,kw", [(384, dict(causal=True, dropout_p=0.1, dropout_seed=1234)),
                                  (300, dict(causal=True))], ids=["dropout-384", "pad-300"])
def test_dropout_and_a_padded_head_dim_match_jax(D, kw):
    """Dropout: the counter-hash mask is bitwise on both sides, so the FA
    bounds hold. D 300 pads to 384 on both sides (JAX: the multiple of 128;
    the port: the kernels' next width), and the padding is sliced off."""
    (j_out, *j_grads), (t_out, *t_grads) = _both(*_inputs(128, D, D), **kw)
    assert t_out.shape[-1] == D and all(g.shape[-1] == D for g in t_grads)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), j_grads, t_grads):
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL, err_msg=name)


def test_pad_head_dim_maps_to_the_kernels_widths_and_holds_each_familys_limit():
    want = {1: 64, 16: 64, 64: 64, 65: 128, 96: 128, 128: 128, 200: 256, 256: 256, 257: 384,
            300: 384, 384: 384, 385: 512, 448: 512, 512: 512, 513: 640, 640: 640}
    for D, Dp in want.items():
        assert kernel_head_dim(D) == Dp, D
        assert pad_head_dim(D, torch.device("cpu")) == Dp
        if D > 256:   # JAX's rule: the next multiple of 128
            assert Dp == round_up_to_multiple(D, 128)
    cuda = torch.device("cuda")   # a device object only: no tensor, no card needed
    assert flash_fwd.HEAD_DIMS[-1] == flash_fwd.MAX_HEAD_DIM == 512
    assert pad_head_dim(448, cuda) == 512
    # Past 512 the dense kernels take D 640; the packed kernels stop at 512
    # (they stopped at 256 before): on the card D 300 pads to 384, D 200 to
    # 256, and D 640 raises.
    assert pad_head_dim(640, cuda) == 640
    with pytest.raises(ValueError, match="head_dim 640 > 512.*ROADMAP.md"):
        pad_head_dim(640, cuda, varlen.PACKED)
    assert pad_head_dim(300, cuda, varlen.PACKED) == 384
    assert pad_head_dim(200, cuda, varlen.PACKED) == 256


def _jax_forward_route(Sq, Sk, head_dim, nbytes):
    """JAX's forward schedule for a plain causal static-shift call at the
    shape its API pads to (`fa2_triton_tpu/ops/flash_fwd.py:1267-1328`)."""
    Dp = round_up_to_multiple(head_dim, 128)
    b = choose_block_sizes(Sq, Sk, Dp, dtype_bits=8 * nbytes, causal=True)
    Sp = round_up_to_multiple(Sq, max(b.block_q, b.block_q_bwd))
    Skp = round_up_to_multiple(Sk, max(b.block_kv, b.block_kv_bwd))
    g = (True, True, (-1, -1), None)
    if jf.tri_square_ok(*g, Sp, Skp, Sq, Sk, head_dim=Dp, dtype_bytes=nbytes):
        return "tri_square"
    if jf.causal_split_ok(*g, False, 0.0, Sp, Skp, Sq, Sk, Dp, dtype_bytes=nbytes):
        return "split"
    if jf.causal_strip_ok(*g, False, Sp, Skp, Sq, Sk, head_dim=Dp, dtype_bytes=nbytes):
        return "strip"
    return "generic"


SHAPES = [(256, 256), (1000, 1000), (1024, 1024), (2047, 2047), (2048, 2048), (4096, 4096),
          (8191, 8191), (1024, 2048)]


class _Routed(Exception):
    pass


def _jax_backward_route(Sq, Sk, head_dim, nbytes, group, **kw):
    """The schedule of JAX's real `flash_attn_backward` dispatch for a plain
    causal static-shift call, on zero-stride stand-ins of the arrays its API
    pads to, its schedule entry points stubbed to record the route (the
    `_recording` fixture); "raises" for a forced split whose gate fails."""
    Dp = round_up_to_multiple(head_dim, 128)
    b = choose_block_sizes(Sq, Sk, Dp, dtype_bits=8 * nbytes, causal=True)
    Sp = round_up_to_multiple(Sq, max(b.block_q, b.block_q_bwd))
    Skp = round_up_to_multiple(Sk, max(b.block_kv, b.block_kv_bwd))
    dt = jnp.bfloat16 if nbytes == 2 else jnp.float32
    q, k = (np.broadcast_to(np.zeros((), dt), (1, h, s, Dp)) for h, s in ((group, Sp), (1, Skp)))
    try:
        jb.flash_attn_backward(q, k, k, q, q, None, None, None, None, causal=True,
                               softmax_scale=0.1, seqlen_q_real=Sq, seqlen_k_real=Sk,
                               static_skip=True, **kw)
    except _Routed as r:
        return r.args[0]
    except AssertionError:
        return "raises"
    raise AssertionError("JAX's dispatch reached no recorder")


@pytest.fixture
def _recording(monkeypatch):
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")

    def recorder(route):
        def record(*args, **kwargs):
            raise _Routed(route)
        return record
    for name, route in (("flash_attn_backward_tri_square", "tri_square"),
                        ("_causal_split_backward", "split"),
                        ("flash_attn_backward_causal_strip", "strip"),
                        ("flash_attn_backward_fused_wl", "worklist")):
        monkeypatch.setattr(jb, name, recorder(route))
    monkeypatch.setattr(jtuning, "choose_fused_bwd", recorder("generic"))


@pytest.mark.parametrize("D", [384, 512])
def test_routes_past_256(D, _recording):
    """Every kernel is built for D 384 / 512, so both directions take JAX's
    route at every shape: the forward's gates, and the backward's real
    dispatch (MHA and GQA 4, bf16 and fp32, with no leaf, a leaf alone and
    the split forced), which reaches the tri-square, the split and the work
    list here; a forced split whose gate fails raises in both."""
    seen, bwd_seen = set(), set()
    for (Sq, Sk), nbytes in itertools.product(SHAPES, (2, 4)):
        fwd = flash_fwd.forward_route(Sq, Sk, D, nbytes, causal=True, static_skip=True)
        assert fwd == _jax_forward_route(Sq, Sk, D, nbytes), (Sq, Sk, nbytes)
        seen.add(fwd)
        for group, leaf, split in itertools.product((1, 4), (None, 512, 1024), (None, True)):
            kw = dict(split_leaf=leaf, causal_split=split)
            try:
                route = flash_bwd.backward_route(Sq, Sk, D, nbytes, causal=True, group=group,
                                                 static_skip=True, **kw)
            except ValueError:
                route = "raises"
            assert route == _jax_backward_route(Sq, Sk, D, nbytes, group, **kw), (
                Sq, Sk, nbytes, group, kw)
            bwd_seen.add(route)
    assert "tri_square" in seen and "generic" in seen   # S 256 and the long shapes
    assert {"tri_square", "split", "worklist", "raises"} <= bwd_seen, bwd_seen
    for S, route in ((256, "tri_square"), (2048, "worklist")):
        assert flash_bwd.backward_route(S, S, D, 2, causal=True, static_skip=True,
                                        route=route) == route


# --------------------------- the model at head_dim 384 ---------------------------

J_CFG = jl.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=2, n_kv_heads=1,
                       hidden_dim=128, head_dim=384, max_seq_len=256, dtype=jnp.float32)
T_CFG = tl.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=2, n_kv_heads=1,
                       hidden_dim=128, head_dim=384, max_seq_len=256, dtype=torch.float32)
PROMPT_LENS = (9, 40, 70)
NEW = (4, 5, 3)


@pytest.fixture(scope="module")
def model():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    return jp, llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")


def _serve(engine, prompts):
    reqs = [engine.submit(p, n) for p, n in zip(prompts, NEW)]
    engine.run()
    assert all(r.done for r in reqs)
    return reqs


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_at_head_dim_384_matches_jax(model, paged):
    jp, tm = model
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in PROMPT_LENS]
    kw = dict(n_slots=2, max_seq=256, paged=paged)
    j_reqs = _serve(JaxEngine(jp, J_CFG, **kw), prompts)
    engine = Engine(tm, T_CFG, **kw)
    t_reqs = _serve(engine, prompts)
    cache = engine.pcache.pools[0] if paged else engine.caches[0]
    assert cache["k"].shape[-1] == 384
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.out_tokens == jr.out_tokens
        np.testing.assert_allclose(tr.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)


def test_loss_and_grads_at_head_dim_384_match_jax(model):
    jp, tm = model
    tokens = np.random.RandomState(4).randint(0, 128, size=(2, 33)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(lambda p: jl.loss_fn(p, jnp.asarray(tokens), J_CFG))(jp)
    t_loss = tl.loss_fn(tm, torch.from_numpy(tokens).long())
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= 1e-5
    j_layers = j_grads["layers"]
    for li, layer in enumerate(tm.layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_allclose(getattr(layer, name).grad.numpy(),
                                       np.asarray(j_layers[li][name]), rtol=0, atol=GRAD_TOL,
                                       err_msg=f"layer {li} {name}")
    np.testing.assert_allclose(tm.embed.grad.numpy(), np.asarray(j_grads["embed"]), rtol=0,
                               atol=GRAD_TOL)
