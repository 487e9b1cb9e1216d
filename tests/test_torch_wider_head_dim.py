"""Head dims past 512 in the port against the JAX package, on the CPU.

JAX pads any head dim to a multiple of 128 and runs its Pallas kernels on it
with no upper limit. Past 512 the port pads the same way (D 600 -> 640,
1000 -> 1024) and its forward, dq + dk/dv pair and decode kernels take any
such width (csrc/any_tiles.cuh: the output columns split over blocks);
dbias, the fused backward schedules and the packed kernels raise there on
CUDA tensors until they are ported (ROADMAP.md queue A item 1(c)). Here the
port runs its plain twins (CPU tensors) and JAX its kernels in interpret
mode, on the same numpy-seeded fp32 inputs, each JAX reference computed
once:

* `flash_attn_func` forward and vjp at D 640 (causal), 1024 (not causal)
  and 600 (-> 640, causal), S 64, B 1, Hq 2 / Hkv 1; a dropout case (the
  counter-hash mask bitwise on both sides) and a bias-and-softcap case at
  D 640: out within 2e-5 and dq / dk / dv within 1e-4, JAX's own
  large-head-dim bounds (tests/test_large_head_dim.py);
* the forward's forced split at D 640 (S 256, leaves of 128) against JAX's
  `flash_attn_forward` with the same flags: o and lse within 2e-5;
* `kernel_head_dim` / `pad_head_dim` against JAX's `head_dim_padded`, and
  the packed kernels' limit;
* a 1-layer model at head_dim 640 (dim 64, 2 / 1 heads): the JAX Engine and
  the port's serve the same prompts contiguous and paged int8 (the stored
  int8 rows bitwise, greedy tokens equal, log-probs within 1e-4), and
  `loss_fn` and its gradients match (1e-5 / 1e-4);
* through a stand-in C library (no build, no card): the wrappers hand the
  kernels D 640 / 1024 with its column-chunk count, and `backward_route`
  takes the dq + dk/dv pair where JAX's real dispatch takes the tri-square
  or the work list.
"""
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.ops import flash_fwd as jf
from fa2_triton_tpu.runtime import Engine as JaxEngine
from fa2_triton_tpu.runtime import kv_cache as jkv

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.ops import _build, decode, flash_bwd, flash_fwd, varlen  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import (  # noqa: E402
    flash_attn_func, kernel_head_dim, pad_head_dim)
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402
from test_torch_large_head_dim import _jax_backward_route, _recording  # noqa: E402,F401

OUT_TOL, GRAD_TOL = 2e-5, 1e-4
LP_TOL = 1e-4
S = 64
SEED = 1234

# (D, kwargs) of the flash_attn_func cases.
CASES = {
    "640-causal": (640, dict(causal=True)),
    "1024": (1024, dict(causal=False)),
    "600-causal": (600, dict(causal=True)),
    "640-dropout": (640, dict(causal=True, dropout_p=0.1, dropout_seed=SEED)),
    "640-bias-softcap": (640, dict(causal=False, softcap=3.0, bias=True)),
}


def _inputs(D, seed):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 0.5, (1, S, 2, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (1, S, 1, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (1, S, 1, D)).astype(np.float32)
    do = rng.normal(0, 0.5, (1, S, 2, D)).astype(np.float32)
    bias = rng.normal(0, 0.5, (1, 2, S, S)).astype(np.float32)
    return q, k, v, do, bias


@pytest.fixture(scope="module")
def jax_refs():
    """{case: (out, dq, dk, dv)} of JAX's flash_attn_func, jitted."""
    refs = {}
    for name, (D, kw) in CASES.items():
        q, k, v, do, bias = _inputs(D, D)
        kw = dict(kw)
        b = jnp.asarray(bias) if kw.pop("bias", False) else None
        f = jax.jit(lambda q, k, v, do, b, kw=tuple(kw.items()): _vjp(q, k, v, do, b, dict(kw)))
        refs[name] = [np.asarray(x) for x in f(*(jnp.asarray(x) for x in (q, k, v, do)), b)]
    return refs


def _vjp(q, k, v, do, b, kw):
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attn_func(q, k, v, attention_bias=b, **kw),
                       q, k, v)
    return (out,) + vjp(do)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attn_func_forward_and_vjp_match_jax(case, jax_refs):
    D, kw = CASES[case]
    q, k, v, do, bias = _inputs(D, D)
    kw = dict(kw)
    b = torch.from_numpy(bias) if kw.pop("bias", False) else None
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attn_func(*leaves, attention_bias=b, **kw)
    out.backward(torch.from_numpy(do))
    assert out.shape == (1, S, 2, D) and all(x.grad.shape[-1] == D for x in leaves)
    j_out, *j_grads = jax_refs[case]
    np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=0, atol=OUT_TOL)
    for name, a, x in zip(("dq", "dk", "dv"), j_grads, leaves):
        np.testing.assert_allclose(x.grad.numpy(), a, rtol=0, atol=GRAD_TOL, err_msg=name)


def test_forced_split_forward_matches_jax():
    """The split (one diag launch over leaves of 128, merged rectangles) at
    D 640, S 256, GQA 2, forced on both sides."""
    rng = np.random.RandomState(5)
    Sq, D = 256, 640
    q, k, v = (rng.normal(0, 0.5, (1, h, Sq, D)).astype(np.float32) for h in (2, 1, 1))
    force = dict(causal=True, softmax_scale=D ** -0.5, static_skip=True, tri_square=False,
                 causal_split=True, split_leaf=128)
    j_o, j_lse = jax.jit(lambda q, k, v: jf.flash_attn_forward(
        q, k, v, jnp.array([[Sq, Sq]], jnp.int32), jnp.zeros((1, 4), jnp.int32), None,
        block_q=128, block_kv=128, **force))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert flash_fwd.forward_route(Sq, Sq, D, 4, **{k: v for k, v in force.items()
                                                    if k != "softmax_scale"}) == "split"
    t_o, t_lse = flash_fwd.flash_attn_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.tensor([[Sq, Sq]], dtype=torch.int32),
        **force)
    np.testing.assert_allclose(t_o.numpy(), np.asarray(j_o), rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0], rtol=0, atol=OUT_TOL)


def test_head_dim_padding_follows_jax():
    cuda = torch.device("cuda")   # a device object only: no tensor, no card needed
    for D in (513, 600, 640, 1000, 1024, 1152):
        want = jkv.KVCacheConfig(n_layers=1, n_kv_heads=1, head_dim=D, max_seq=128,
                                 n_slots=1).head_dim_padded
        assert kernel_head_dim(D) == want == -(-D // 128) * 128, D
        assert pad_head_dim(D, cuda) == pad_head_dim(D, torch.device("cpu")) == want
        assert flash_fwd.col_chunks(want) == -(-want // 256)
        with pytest.raises(ValueError, match=f"head_dim {D} > 512.*queue A item 1"):
            pad_head_dim(D, cuda, varlen.PACKED)
    assert pad_head_dim(1152, torch.device("cpu"), varlen.PACKED) == 1152
    assert flash_fwd.col_chunks(512) == 1


def test_chunk_constants_mirror_the_kernels():
    """ops/flash_fwd.py's COL_CHUNK is csrc/any_tiles.cuh's any::DC, and
    ops/decode.py's ANY_CHUNK csrc/decode_any.cuh's, a multiple of the
    128-row page; decode takes its chunk by head dim."""
    csrc = _build.CSRC
    dc = int(re.search(r"constexpr int DC = (\d+);", (csrc / "any_tiles.cuh").read_text())[1])
    any_chunk = int(re.search(r"constexpr int ANY_CHUNK = (\d+);",
                              (csrc / "decode_any.cuh").read_text())[1])
    assert dc == flash_fwd.COL_CHUNK and any_chunk == decode.ANY_CHUNK
    assert any_chunk % decode.PAGE_MULTIPLE == 0
    assert decode.chunk_count(4096, 512) == 8 and decode.chunk_count(4096, 640) == 16
    assert decode.live_chunks(700, 4096, head_dim=1024) == 3


# --------------------------- the model at head_dim 640 ---------------------------

J_CFG = jl.LlamaConfig(vocab_size=128, dim=64, n_layers=1, n_heads=2, n_kv_heads=1,
                       hidden_dim=128, head_dim=640, max_seq_len=128, dtype=jnp.float32)
T_CFG = tl.LlamaConfig(vocab_size=128, dim=64, n_layers=1, n_heads=2, n_kv_heads=1,
                       hidden_dim=128, head_dim=640, max_seq_len=128, dtype=torch.float32)
PROMPT_LENS = (9, 30)
NEW = (3, 4)


@pytest.fixture(scope="module")
def model():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    return jp, llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")


def _serve(engine, prompts):
    reqs = [engine.submit(p, n) for p, n in zip(prompts, NEW)]
    engine.run()
    assert all(r.done for r in reqs)
    return reqs


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged-int8"])
def test_engine_at_head_dim_640_matches_jax(model, paged):
    jp, tm = model
    prompts = [np.random.RandomState(3).randint(0, 128, size=n).tolist() for n in PROMPT_LENS]
    kw = dict(n_slots=2, max_seq=128)
    if paged:
        jkw = dict(kw, paged=True, page_size=128, qdtype=jnp.int8)
        tkw = dict(kw, paged=True, page_size=128, qdtype=torch.int8)
    else:
        jkw = tkw = kw
    j_engine = JaxEngine(jp, J_CFG, **jkw)
    j_reqs = _serve(j_engine, prompts)
    engine = Engine(tm, T_CFG, **tkw)
    t_reqs = _serve(engine, prompts)
    if paged:
        # The pools as stored: int8 values bitwise, 640 wide as JAX's.
        for jpool, tpool in zip(j_engine.pcache.pools, engine.pcache.pools):
            assert tpool["k"].dtype == torch.int8 and tpool["k"].shape[-1] == 640
            for name in ("k", "v"):
                np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    else:
        assert engine.caches[0]["k"].shape[-1] == 640
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.out_tokens == jr.out_tokens
        np.testing.assert_allclose(tr.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)


def test_loss_and_grads_at_head_dim_640_match_jax(model):
    jp, tm = model
    tokens = np.random.RandomState(4).randint(0, 128, size=(2, 33)).astype(np.int32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.loss_fn(p, t, J_CFG)))(jp, jnp.asarray(tokens))
    t_loss = tl.loss_fn(tm, torch.from_numpy(tokens).long())
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= 1e-5
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(getattr(tm.layers[0], name).grad.numpy(),
                                   np.asarray(j_grads["layers"][0][name]), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(tm.embed.grad.numpy(), np.asarray(j_grads["embed"]), rtol=0,
                               atol=GRAD_TOL)


# ------------------------ the C calls and the routes ------------------------

class _Call(Exception):
    pass


@pytest.fixture
def recorded(monkeypatch):
    """A stand-in library whose entry points raise _Call with their
    arguments; the wrappers' CUDA checks see CUDA-looking tensors
    (`_cuda_like`), and their outputs are allocated on the CPU."""
    lib = types.SimpleNamespace()
    for name in ("fa2_flash_fwd", "fa2_flash_fwd_causal", "fa2_flash_fwd_rect", "fa2_flash_bwd",
                 "fa2_decode"):
        def fn(*args, name=name):
            raise _Call(name, args)
        setattr(lib, name, fn)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(flash_fwd, "_c_fns", {})
    monkeypatch.setattr(flash_bwd, "_c_fns", {})
    monkeypatch.setattr(decode, "_c_fn", None)
    for mod, name in ((flash_fwd, "_new_out"), (flash_bwd, "_new_grads")):
        alloc = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda q, *a, alloc=alloc: alloc(
            q.as_subclass(torch.Tensor), *(x.as_subclass(torch.Tensor) if
                                           isinstance(x, torch.Tensor) else x for x in a)))
    return lib


def _cuda_like(x):
    """x on a tensor subclass whose device reads "cuda" (the wrappers check
    devices and strides, then call the library)."""
    class Dev(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)
    return x.as_subclass(Dev)


@pytest.mark.parametrize("D", [640, 1024])
def test_wrappers_hand_the_kernels_the_head_dim_and_its_chunks(D, recorded):
    chunks = -(-D // 256)
    q, k, v = (_cuda_like(torch.zeros(1, h, 64, D, dtype=torch.bfloat16)) for h in (4, 1, 1))
    lens = _cuda_like(torch.tensor([[64, 64]], dtype=torch.int32))
    with pytest.raises(_Call) as call:
        flash_fwd._flash_fwd_launch(q, k, v, lens, 0, 0, None, causal=True, softmax_scale=0.1,
                                    window=(-1, -1), softcap=0.0, dropout_p=0.0, dropout_seed=0,
                                    seqlen_q_real=None, seqlen_k_real=None)
    name, args = call.value.args
    argtypes = flash_fwd._ARGTYPES[name]
    assert name == "fa2_flash_fwd" and len(args) == len(argtypes)
    assert args[6] == D and args[-2] == chunks and args[-3] == 0   # D, chunks, lse stride
    o, lse = flash_fwd._new_out(q, 64)
    with pytest.raises(_Call) as call:
        flash_fwd._schedule_launch("rect_merge", q, k, v, lens, 0, 0, _cuda_like(o),
                                   _cuda_like(lse), softmax_scale=0.1, dropout_p=0.0,
                                   dropout_seed=0, seqlen_q_real=None, seqlen_k_real=None,
                                   tail=[64, 0, 64, 0, 64, 0])
    name, args = call.value.args
    assert name == "fa2_flash_fwd_rect" and len(args) == len(flash_fwd._ARGTYPES[name])
    # The merge reads the previous lse from a copy of its own.
    assert args[-2] == chunks and args[-3] not in (None, lse.data_ptr())
    lse_b, delta = (_cuda_like(torch.zeros(1, 4, 64)) for _ in range(2))
    with pytest.raises(_Call) as call:
        flash_bwd._pair_backward(q, k, v, q, lse_b, delta, lens, 0, 0, None, causal=True,
                                 softmax_scale=0.1, window=(-1, -1), softcap=0.0,
                                 compute_dbias=False, dropout_p=0.0, dropout_seed=0,
                                 seqlen_q_real=None, seqlen_k_real=None)
    which, args = call.value.args[1][0], call.value.args[1][1:]
    assert which == 0 and args[6] == D and args[-4] == chunks   # then k_prescaled, tile rows
    qd = _cuda_like(torch.zeros(2, 4, D, dtype=torch.bfloat16))
    cache = _cuda_like(torch.zeros(2, 1, 256, D, dtype=torch.int8))
    scale = _cuda_like(torch.ones(2, 1, 1, 256))
    with pytest.raises(_Call) as call:
        decode.decode_attention(qd, cache, cache, _cuda_like(torch.ones(2, dtype=torch.int32)),
                                scale, scale)
    name, args = call.value.args
    assert name == "fa2_decode" and args[5] == D and args[1] == 1   # D, the int8 kind
    assert args[-4] == decode.chunk_count(256, D) == 1   # n_chunks: one chunk of 256 rows


def test_backward_takes_the_pair_where_jax_takes_a_fused_schedule(_recording):
    """JAX's real dispatch takes the tri-square (MHA, S 256) and the work
    list (MHA, S 1024) at D 640 and 1024; the port declines both past 512
    and takes the dq + dk/dv pair, and raises when one is forced."""
    for D in (640, 1024):
        for Sq, jax_route in ((256, "tri_square"), (1024, "worklist")):
            assert _jax_backward_route(Sq, Sq, D, 2, 1) == jax_route
            assert flash_bwd.backward_route(Sq, Sq, D, 2, causal=True, group=1,
                                            static_skip=True) == "generic"
            with pytest.raises(ValueError, match="queue A item 1"):
                flash_bwd.backward_route(Sq, Sq, D, 2, causal=True, group=1, static_skip=True,
                                         route=jax_route)
        with pytest.raises(ValueError, match="queue A item 1"):
            flash_bwd.backward_route(4096, 4096, D, 2, causal=True, static_skip=True,
                                     causal_split=True, split_leaf=1024)
    # The slice's model (group 4, S 2048): JAX takes the pair too.
    assert _jax_backward_route(2048, 2048, 1024, 2, 4) == "generic"
    assert flash_bwd.backward_route(2048, 2048, 1024, 2, causal=True, group=4,
                                    static_skip=True) == "generic"
    assert flash_fwd.forward_route(2048, 2048, 1024, 2, causal=True, static_skip=True) == "generic"
