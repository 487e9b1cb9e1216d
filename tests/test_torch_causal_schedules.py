"""The port's causal forward schedules (plain twins on the CPU) against the
JAX package's (Pallas in interpret mode, with the small forced leaf and
sub-tile of tests/test_causal_split.py and tests/test_causal_strip.py):
the strip (B10), the diagonal leaves (B9 diag), the rectangle with and
without its merge (B11, B1 merge), the split schedule that strings them
together, and `flash_attn_forward`'s routing with the gates it copies.

Inputs from numpy RandomState, fp32, D 128, GQA 4 / 2 heads. Tolerance 1e-5
max abs on o and on the base-2 lse, with the same -inf pattern: both sides
compute in fp32, and only the order of the sums differs.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.ops import flash_fwd as jf
from fa2_triton_tpu.ops.tuning import choose_block_sizes
from fa2_triton_tpu.utils import round_up_to_multiple

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

TOL = 1e-5
SEED = 7          # the dropout seed of every dropout case
D = 128
SCALE = D ** -0.5


def _inputs(B, Hq, Hkv, Sq, Sk, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 0.5, (B, h, s, D)).astype(np.float32)
            for h, s in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk))]


def _jax_args(arrays, B, q_len, kv_len):
    lens = jnp.broadcast_to(jnp.array([[q_len, kv_len]], jnp.int32), (B, 2))
    return [jnp.asarray(x) for x in arrays] + [lens, jnp.array([[0, 0, SEED, 0]], jnp.int32)]


def _torch_args(arrays, B, q_len, kv_len):
    return [torch.from_numpy(x) for x in arrays] + [
        torch.tensor([[q_len, kv_len]] * B, dtype=torch.int32)]


def _close(t_out, j_out):
    """Port (o, lse [..]) against JAX (o, lse [.., 1])."""
    (t_o, t_lse), (j_o, j_lse) = t_out, j_out
    np.testing.assert_allclose(t_o.numpy(), np.asarray(j_o), rtol=0, atol=TOL)
    j_lse, t_lse = np.asarray(j_lse)[..., 0], t_lse.numpy()
    assert np.array_equal(np.isneginf(t_lse), np.isneginf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(t_lse[fin], j_lse[fin], rtol=0, atol=TOL)


# ------------------------------ pure Python --------------------------------

# (Sq, Sk, sq_real, sk_real): padded lengths first, as JAX's gates see them.
GATE_SHAPES = [(512, 512, 512, 512), (1024, 1024, 1000, 1000), (2048, 2048, 2047, 2047),
               (2048, 4096, 2048, 4096), (3072, 3072, 2560, 2560), (4096, 4096, 4095, 4095),
               (4096, 4096, 4096, 4096), (4096, 4096, 4000, 3968), (6144, 6144, 6144, 6144),
               (8192, 8192, 8192, 8192), (8192, 8192, 7700, 7700), (16384, 16384, 15872, 15872),
               (512, 1024, 300, 812), (1024, 512, 1024, 512)]
# Departures from a plain causal call, one at a time.
GATE_FLAGS = [dict(), dict(causal=False), dict(static_skip=False), dict(window=(64, -1)),
              dict(window=(-1, 0)), dict(bias="bias"), dict(varlen=True), dict(softcap=5.0)]


def _flags(f):
    return dict(dict(causal=True, static_skip=True, window=(-1, -1), bias=None, varlen=False,
                     softcap=0.0), **f)


def test_rect_plan_and_leaf_match_jax():
    for n in range(2, 9):
        assert flash_fwd.causal_split_rects(n) == jf.causal_split_rects(n)
    for d, nbytes in itertools.product((64, 128, 256), (2, 4)):
        assert flash_fwd.split_leaf_t(d, nbytes) == jf.split_leaf_t(d, nbytes)


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_gates_match_jax(head_dim):
    """The three gates on a grid of shapes (shifted, boundary Sk * D, long),
    flags (window, softcap, bias, varlen, not static) and dtype sizes."""
    for (Sq, Sk, sq, sk), f, nbytes in itertools.product(GATE_SHAPES, GATE_FLAGS, (2, 4)):
        g = _flags(f)
        tri = (g["causal"], g["static_skip"], g["window"], g["bias"], Sq, Sk, sq, sk)
        assert (flash_fwd.tri_square_ok(*tri, head_dim=head_dim, softcap=g["softcap"],
                                        dtype_bytes=nbytes)
                == jf.tri_square_ok(*tri, head_dim=head_dim, softcap=g["softcap"],
                                    dtype_bytes=nbytes))
        strip = (g["causal"], g["static_skip"], g["window"], g["bias"], g["varlen"], Sq, Sk, sq, sk)
        assert (flash_fwd.causal_strip_ok(*strip, head_dim=head_dim, softcap=g["softcap"],
                                          dtype_bytes=nbytes)
                == jf.causal_strip_ok(*strip, head_dim=head_dim, softcap=g["softcap"],
                                      dtype_bytes=nbytes))
        for leaf in (None, 512, 1024):
            split = (g["causal"], g["static_skip"], g["window"], g["bias"], g["varlen"],
                     g["softcap"], Sq, Sk, sq, sk, head_dim)
            assert (flash_fwd.causal_split_ok(*split, leaf_t=leaf, dtype_bytes=nbytes)
                    == jf.causal_split_ok(*split, leaf_t=leaf, dtype_bytes=nbytes))


def _jax_route(Sq, Sk, head_dim, nbytes, **g):
    """The schedule JAX's flash_attn_forward (l.1267-1328) takes at the
    shape JAX's own API pads to (attention.py:207-222: the head dim to 128
    lanes, each length to its forward and backward blocks) and the real
    lengths."""
    Dp = round_up_to_multiple(head_dim, 128)
    blocks = choose_block_sizes(Sq, Sk, Dp, dtype_bits=8 * nbytes, causal=g["causal"],
                                has_bias=g["bias"] is not None, has_window=g["window"] != (-1, -1),
                                has_varlen=g["varlen"])
    Sp = round_up_to_multiple(Sq, max(blocks.block_q, blocks.block_q_bwd))
    Skp = round_up_to_multiple(Sk, max(blocks.block_kv, blocks.block_kv_bwd))
    if jf.tri_square_ok(g["causal"], g["static_skip"], g["window"], g["bias"], Sp, Skp, Sq, Sk,
                        head_dim=Dp, softcap=g["softcap"], dtype_bytes=nbytes):
        return "tri_square"
    if jf.causal_split_ok(g["causal"], g["static_skip"], g["window"], g["bias"], g["varlen"],
                          g["softcap"], Sp, Skp, Sq, Sk, Dp, dtype_bytes=nbytes):
        return "split"
    if jf.causal_strip_ok(g["causal"], g["static_skip"], g["window"], g["bias"], g["varlen"],
                          Sp, Skp, Sq, Sk, head_dim=Dp, softcap=g["softcap"],
                          dtype_bytes=nbytes):
        return "strip"
    return "generic"


LENGTHS = [(100, 100), (2047, 2047), (2049, 2049), (2560, 2560), (3200, 3200), (3584, 3584),
           (4095, 4095), (4096, 4096), (6144, 6144), (7300, 7300), (7700, 7700), (8192, 8192),
           (2048, 4096), (1000, 1000), (1600, 1600), (3000, 3000), (24, 70)]


def test_routes_match_jax(monkeypatch):
    """`forward_route` (what `flash_attn_forward` takes) equals the route of
    JAX's gates at the shape JAX's API pads to (its own block choice, the
    persisted tuning table off) and the real lengths, kill switches
    included; forcing a route whose gate fails raises."""
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")
    seen = set()
    for (Sq, Sk), d, nbytes, f in itertools.product(LENGTHS, (64, 128, 256), (2, 4), GATE_FLAGS):
        g = _flags(f)
        route = flash_fwd.forward_route(Sq, Sk, d, nbytes, **g)
        assert route == _jax_route(Sq, Sk, d, nbytes, **g), (Sq, Sk, d, nbytes, f)
        seen.add(route)
    assert seen == {"tri_square", "split", "strip", "generic"}
    plain = _flags({})
    assert flash_fwd.forward_route(4095, 4095, 128, 2, **plain) == "split"
    assert flash_fwd.forward_route(2047, 2047, 128, 2, **plain) == "tri_square"
    assert flash_fwd.forward_route(2560, 2560, 128, 2, **plain) == "strip"
    assert flash_fwd.forward_route(2048, 4096, 128, 2, **plain) == "strip"
    monkeypatch.setenv("FA2_DISABLE_SPLIT", "yes")
    assert flash_fwd.forward_route(4095, 4095, 128, 2, **plain) == "strip"
    monkeypatch.setenv("FA2_DISABLE_STRIP", "1")
    assert flash_fwd.forward_route(4095, 4095, 128, 2, **plain) == "generic"
    with pytest.raises(ValueError, match="causal_split|split forced"):
        flash_fwd.forward_route(4095, 4095, 128, 2, causal_split=True, **plain)
    monkeypatch.delenv("FA2_DISABLE_SPLIT")
    monkeypatch.delenv("FA2_DISABLE_STRIP")
    assert flash_fwd.forward_route(4095, 4095, 128, 2, causal_split=False, **plain) == "strip"
    with pytest.raises(ValueError, match="strip forced"):
        flash_fwd.forward_route(4096, 4096, 128, 4, causal_strip=True, **plain)   # fp32
    with pytest.raises(ValueError, match="tri_square forced"):
        flash_fwd.forward_route(4096, 4096, 128, 2, tri_square=True, **plain)
    q = torch.zeros(1, 2, 64, 128)
    with pytest.raises(ValueError, match="split forced"):
        flash_fwd.flash_attn_forward(q, q, q, torch.tensor([[64, 64]], dtype=torch.int32),
                                     causal=False, softmax_scale=SCALE, static_skip=True,
                                     causal_split=True)


def test_fp16_routes_on_its_own_width():
    """fp16: the port's kernels compute in fp16 (2 bytes), JAX upcasts to
    fp32 (attention.py:182-195), so at S 1600 / D 128 the port takes the
    tri-square (generic) kernel where JAX takes the split. Both compute the
    same function; the gates are the same, fed each package's dtype size."""
    g = _flags({})
    assert flash_fwd.forward_route(1600, 1600, 128, 2, **g) == "tri_square"
    assert _jax_route(1600, 1600, 128, 4, **g) == "split"


class _Routed(Exception):
    pass


def _recorder(route):
    def record(*args, **kwargs):
        raise _Routed(route)
    return record


# (Sq, Sk, D, dtype) of public causal calls: lengths that JAX's blocks pad
# past the next 512 (S 3200 to 4096, S 7300 to 8192), head dims it pads to
# 128 lanes (64), fp32's smaller blocks, the tri-square range, a query chunk
# against a longer context, and the split at D 256.
API_CASES = [(3200, 3200, 128, "bfloat16"), (3584, 3584, 128, "bfloat16"),
             (4095, 4095, 128, "bfloat16"), (6144, 6144, 128, "bfloat16"),
             (7300, 7300, 128, "bfloat16"), (2047, 2047, 128, "bfloat16"),
             (2048, 4096, 128, "bfloat16"), (4096, 4096, 64, "bfloat16"),
             (2560, 2560, 64, "bfloat16"), (2048, 2048, 256, "bfloat16"),
             (1600, 1600, 128, "float32"), (1600, 1600, 64, "float32"),
             (3700, 3700, 64, "float32")]


def test_public_calls_route_as_jax_does(monkeypatch):
    """JAX's flash_attn_func and the port's take the same schedule: each
    package's schedule entry points are replaced by recorders (JAX's
    generic kernel by a recording pallas_call), so the route is read where
    each package really dispatches, after its own padding."""
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")
    for name, route in (("flash_attn_forward_tri_square", "tri_square"),
                        ("_causal_split_forward", "split"),
                        ("flash_attn_forward_causal_strip", "strip")):
        monkeypatch.setattr(jf, name, _recorder(route))
        monkeypatch.setattr(flash_fwd, name, _recorder(route))
    monkeypatch.setattr(jf.pl, "pallas_call", _recorder("generic"))
    monkeypatch.setattr(flash_fwd, "_generic_forward", _recorder("generic"))
    seen = set()
    for Sq, Sk, d, dt in API_CASES:
        routes = []
        for fa, zeros in ((jfa.flash_attn_func, lambda s, h: jnp.zeros((1, s, h, d), dt)),
                          (flash_attn_func,
                           lambda s, h: torch.zeros(1, s, h, d, dtype=getattr(torch, dt)))):
            with pytest.raises(_Routed) as rec:
                fa(zeros(Sq, 2), zeros(Sk, 1), zeros(Sk, 1), causal=True)
            routes.append(rec.value.args[0])
        assert routes[0] == routes[1], (Sq, Sk, d, dt, routes)
        assert routes[1] == flash_fwd.forward_route(Sq, Sk, d, 4 if dt == "float32" else 2,
                                                    causal=True, static_skip=True)
        seen.add(routes[0])
    assert seen == {"tri_square", "split", "strip", "generic"}


def test_merge_softmax_partials_matches_jax():
    """Random partials with dead rows (lse = -inf, o = 0) on one side, on
    both, and on neither; dead + dead stays dead with no NaN."""
    rng = np.random.RandomState(3)
    o1, o2 = (rng.normal(0, 1, (2, 3, 8, 16)).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.normal(4, 2, (2, 3, 8)).astype(np.float32) for _ in range(2))
    dead1 = np.zeros((2, 3, 8), bool)
    dead1[:, :, 0:2] = dead1[:, :, 4:6] = True          # rows 4-5 dead on both sides
    dead2 = np.zeros((2, 3, 8), bool)
    dead2[:, :, 2:6] = True
    for o, l, dead in ((o1, l1, dead1), (o2, l2, dead2)):
        o[dead] = 0.0
        l[dead] = -np.inf
    t_o, t_l = flash_fwd.merge_softmax_partials(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    j_o, j_l = jf.merge_softmax_partials(jnp.asarray(o1), jnp.asarray(l1)[..., None],
                                         jnp.asarray(o2), jnp.asarray(l2)[..., None])
    _close((t_o, t_l), (j_o, j_l))
    assert not torch.isnan(t_o).any() and (t_o[:, :, 4:6] == 0).all()
    assert torch.isneginf(t_l[:, :, 4:6]).all() and torch.isfinite(t_l[:, :, :4]).all()


# ------------------------------ the schedules ------------------------------

@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
@pytest.mark.parametrize("Sq,Sk", [(512, 512), (256, 512)])
def test_strip_matches_jax(Sq, Sk, dropout_p):
    """B10 at shift 0 and shift 256 (Sq < Sk), JAX with sub 128."""
    arrays = _inputs(1, 4, 2, Sq, Sk, seed=Sq + int(10 * dropout_p))
    kw = dict(softmax_scale=SCALE, dropout_p=dropout_p)
    j = jf.flash_attn_forward_causal_strip(*_jax_args(arrays, 1, Sq, Sk), sub=128, **kw)
    t = flash_fwd.flash_attn_forward_causal_strip(*_torch_args(arrays, 1, Sq, Sk),
                                                  dropout_seed=SEED, **kw)
    _close(t, j)


def _diag_case():
    """S 384 = three leaves of 128, lens 300 (a dead tail), dropout 0.3."""
    arrays = _inputs(2, 4, 2, 384, 384, seed=11)
    kw = dict(softmax_scale=SCALE, dropout_p=0.3, seqlen_q_real=300, seqlen_k_real=300)
    return arrays, kw


def test_diag_matches_jax():
    arrays, kw = _diag_case()
    j = jf.flash_attn_forward_causal_diag(*_jax_args(arrays, 2, 300, 300), T=128, sub=128, **kw)
    t = flash_fwd.flash_attn_forward_causal_diag(*_torch_args(arrays, 2, 300, 300), T=128,
                                                 dropout_seed=SEED, **kw)
    _close(t, j)


@pytest.mark.parametrize("merge", [False, True])
def test_rect_matches_jax(merge):
    """Rows [256, 384) against columns [0, 256) of the diag case's tensors;
    merge mode over one starting (o, lse), JAX's diag result, copied into
    each side."""
    arrays, kw = _diag_case()
    region = dict(row0=256, col0=0, nrows=128, ncols=256)
    jargs = _jax_args(arrays, 2, 300, 300)
    j_prev = t_prev = None
    if merge:
        o_d, lse_d = (np.asarray(x) for x in jf.flash_attn_forward_causal_diag(
            *jargs, T=128, sub=128, **kw))
        j_prev = (jnp.asarray(o_d), jnp.asarray(lse_d))
        t_prev = (torch.from_numpy(o_d.copy()), torch.from_numpy(lse_d[..., 0].copy()))
    j = jf.flash_attn_forward_rect(*jargs, block_q=128, block_kv=128, merge_prev=j_prev,
                                   **region, **kw)
    t = flash_fwd.flash_attn_forward_rect(*_torch_args(arrays, 2, 300, 300), dropout_seed=SEED,
                                          merge_prev=t_prev, **region, **kw)
    assert t[0].shape == ((2, 4, 384, D) if merge else (2, 4, 128, D))
    if merge:
        assert t[0] is t_prev[0] and t[1] is t_prev[1]     # merged in place
    _close(t, j)


@pytest.mark.parametrize("n", [2, 3])
def test_split_matches_jax(n):
    S = 128 * n
    arrays = _inputs(1, 4, 2, S, S, seed=20 + n)
    kw = dict(softmax_scale=SCALE)
    j = jf._causal_split_forward(*_jax_args(arrays, 1, S, S), leaf_t=128, **kw)
    t = flash_fwd._causal_split_forward(*_torch_args(arrays, 1, S, S), leaf_t=128, **kw)
    _close(t, j)


def test_split_gqa_dropout_dead_tail_matches_jax():
    """tests/test_causal_split.py's case: GQA, dead tail rows past 400 of
    512 (lse -inf through the merge), dropout 0.3; the port reaches the
    split through `flash_attn_forward`'s routing with the leaf forced."""
    arrays = _inputs(2, 4, 2, 512, 512, seed=1)
    kw = dict(softmax_scale=SCALE, dropout_p=0.3, seqlen_q_real=400, seqlen_k_real=400)
    force = dict(static_skip=True, tri_square=False, causal_split=True, split_leaf=128)
    assert flash_fwd.forward_route(512, 512, D, 4, causal=True, seqlen_q_real=400,
                                   seqlen_k_real=400, **force) == "split"
    j = jf._causal_split_forward(*_jax_args(arrays, 2, 400, 400), leaf_t=128, **kw)
    t = flash_fwd.flash_attn_forward(*_torch_args(arrays, 2, 400, 400), causal=True,
                                     dropout_seed=SEED, **force, **kw)
    _close(t, j)


def test_flash_attn_func_takes_the_split_as_jax_does():
    """fp32 D 256 at S 1000 (padded 1024): both packages route the public
    call to the split (two leaves of 512), with dropout."""
    assert flash_fwd.forward_route(1000, 1000, 256, 4, causal=True, static_skip=True) == "split"
    rng = np.random.RandomState(5)
    q, k, v = (rng.normal(0, 0.5, (1, 1000, h, 256)).astype(np.float32) for h in (4, 2, 2))
    kw = dict(causal=True, dropout_p=0.2, dropout_seed=SEED, return_lse=True)
    j_out, j_lse = jfa.flash_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    t_out, t_lse = flash_attn_func(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   **kw)
    _close((t_out, t_lse), (j_out, np.asarray(j_lse)[..., None]))
