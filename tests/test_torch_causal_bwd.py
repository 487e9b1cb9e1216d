"""The port's causal backward schedules (plain twins on the CPU) against the
JAX package's (Pallas in interpret mode, at the small forced sizes of
tests/test_worklist_bwd.py and tests/test_causal_split.py): the tri-square
(B13), the diagonal leaves and the rectangle (B13 diag, B13 rect), the split
schedule that adds them up, the work list (B14) and its host table, and
`flash_attn_backward`'s routing with the gates it copies; then the public
path and the Qwen1.5-7B preset.

Inputs from numpy RandomState, fp32, D 128, B 1-2, Hq 4 with Hkv 4 (MHA) or
2 (GQA). Tolerance 1e-5 max abs on dq, dk and dv (both sides compute in
fp32, only the order of the sums differs), 2e-5 for the work list, as JAX's
own test allows it (tests/test_worklist_bwd.py:45); the table bit for bit.
"""
import dataclasses
import itertools
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.models import convert as jconvert
from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.ops import flash_bwd as jb
from fa2_triton_tpu.ops import flash_fwd as jf
from fa2_triton_tpu.ops import tuning as jtuning
from fa2_triton_tpu.ops.tuning import choose_block_sizes
from fa2_triton_tpu.utils import round_up_to_multiple

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.examples import train as ttrain  # noqa: E402
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import (  # noqa: E402
    llama_from_jax_params, llama_to_jax_params)
from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

TOL = 1e-5
WL_TOL = 2e-5
SEED = 7          # the dropout seed of every dropout case
D = 128
SCALE = D ** -0.5


def _inputs(B, Hq, Hkv, S, seed):
    """q, k, v, do and a dlse cotangent."""
    rng = np.random.RandomState(seed)
    x = [rng.normal(0, 0.5, (B, h, S, D)).astype(np.float32) for h in (Hq, Hkv, Hkv, Hq)]
    return x + [rng.normal(0, 0.1, (B, Hq, S)).astype(np.float32)]


def _forward(arrays, B, n_real, dropout_p):
    """JAX's generic forward (o, lse [.., 1]) of q, k, v with lens n_real."""
    lens = jnp.broadcast_to(jnp.array([[n_real, n_real]], jnp.int32), (B, 2))
    scal = jnp.array([[0, 0, SEED, 0]], jnp.int32)
    q, k, v = (jnp.asarray(x) for x in arrays[:3])
    o, lse = jf.flash_attn_forward(
        q, k, v, lens, scal, None, causal=True, softmax_scale=SCALE, dropout_p=dropout_p,
        seqlen_q_real=n_real, seqlen_k_real=n_real, static_skip=True, block_q=128, block_kv=128,
        tri_square=False, causal_split=False, causal_strip=False)
    # The cotangent of dead rows' -inf lse is 0, as JAX's autodiff hands it.
    dlse = jnp.where(jnp.isfinite(lse), jnp.asarray(arrays[4])[..., None], 0.0)
    return lens, scal, np.asarray(o), np.asarray(lse), dlse


def _torch(arrays, o, lse, dlse, B, n_real):
    q, k, v, do = (torch.from_numpy(x) for x in arrays[:4])
    return (q, k, v, do, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse[..., 0])),
            torch.tensor([[n_real, n_real]] * B, dtype=torch.int32),
            torch.from_numpy(np.array(dlse)[..., 0]))


def _close(t_grads, j_grads, tol=TOL):
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol, err_msg=name)


# ------------------------------ pure Python --------------------------------

# (Sq, Sk, sq_real, sk_real): padded lengths first, as JAX's gates see them.
GATE_SHAPES = [(512, 512, 512, 512), (512, 512, 450, 450), (2048, 2048, 2047, 2047),
               (2048, 4096, 2048, 4096), (3072, 3072, 2560, 2560), (4096, 4096, 4095, 4095),
               (4096, 4096, 4096, 4096), (6144, 6144, 6143, 6143), (8192, 8192, 8191, 8191),
               (8192, 8192, 7700, 7700), (16384, 16384, 15872, 15872), (4096, 8192, 4096, 8192),
               (8192, 4096, 8192, 4096), (512, 1024, 300, 812)]
# Departures from a plain causal call, one at a time.
GATE_FLAGS = [dict(), dict(causal=False), dict(static_skip=False), dict(window=(64, -1)),
              dict(window=(-1, 0)), dict(varlen=True), dict(softcap=5.0)]


def _flags(f):
    return dict(dict(causal=True, static_skip=True, window=(-1, -1), bias=None, varlen=False,
                     softcap=0.0), **f)


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_gates_match_jax(head_dim):
    """The strip, split, work-list and tri-square gates and the split leaf
    on a grid of shapes (shifted, long, the boundary Sk * D == 4096 * 128),
    flags (window, softcap, varlen, not static), fp32 and GQA."""
    for (Sq, Sk, sq, sk), f, nbytes, group in itertools.product(
            GATE_SHAPES, GATE_FLAGS, (2, 4), (1, 2, 4)):
        g = _flags(f)
        assert flash_bwd.bwd_split_leaf_t(head_dim, group, nbytes) == \
            jb.bwd_split_leaf_t(head_dim, group, nbytes)
        head = (g["causal"], g["static_skip"], g["window"], None, g["varlen"], g["softcap"],
                Sq, Sk, sq, sk)
        assert (flash_bwd.bwd_causal_strip_ok(*head, head_dim=head_dim, dtype_bytes=nbytes)
                == jb.bwd_causal_strip_ok(*head, head_dim=head_dim, dtype_bytes=nbytes))
        for leaf in (None, 128, 1024, 2048):
            assert (flash_bwd.causal_split_bwd_ok(*head, head_dim, group, leaf_t=leaf,
                                                  dtype_bytes=nbytes)
                    == jb.causal_split_bwd_ok(*head, head_dim, group, leaf_t=leaf,
                                              dtype_bytes=nbytes))
        wl = (g["causal"], g["static_skip"], g["window"], g["varlen"], g["softcap"], Sq, Sk, sq,
              sk, head_dim, group, nbytes)
        assert flash_bwd.causal_wl_bwd_config(*wl) == jb.causal_wl_bwd_config(*wl)
        # JAX's inline tri-square gate (flash_bwd.py:2196-2203).
        want = (g["softcap"] == 0.0
                and jf.tri_square_ok(g["causal"], g["static_skip"], g["window"], None, Sq, Sk,
                                     sq, sk, head_dim=head_dim, dtype_bytes=nbytes)
                and group * Sq * head_dim * nbytes <= 2048 * 128 * 2)
        assert flash_bwd.tri_square_bwd_ok(g["causal"], g["static_skip"], g["window"],
                                           g["softcap"], Sq, Sk, sq, sk, head_dim, group,
                                           nbytes) == want
    # The boundary: strictly below Sk * D == 4096 * 128 for the strip.
    plain = (True, True, (-1, -1), None, False, 0.0)
    assert not flash_bwd.bwd_causal_strip_ok(*plain, 4096, 4096, 4096, 4096, head_dim=128)
    assert flash_bwd.bwd_causal_strip_ok(*plain, 4096, 4096, 4096, 4096, head_dim=64)


def test_worklist_table_matches_jax_bit_for_bit():
    """build_causal_bwd_worklist on a grid: single and multi strip, group 1
    and 2, shifts, windows, tri_ok on and off, dq_whole on and off, not
    causal with a right window."""
    n = 0
    for nq, nws, nsub_strip, group, shift, window, causal, tri_ok, dq_whole in itertools.product(
            (4, 6), (4, 8), (2, 4, 8), (1, 2), (0, 256, -256), ((-1, -1), (300, -1), (200, 100)),
            (True, False), (False, True), (False, True)):
        if causal and window[1] >= 0:
            continue
        args = (nq, 256, 256, nws, nsub_strip, group, shift)
        kw = dict(window=window, causal=causal, tri_ok=tri_ok, dq_whole=dq_whole)
        try:
            want = jb.build_causal_bwd_worklist(*args, **kw)
        except IndexError:   # an empty schedule: JAX indexes steps[0]
            with pytest.raises(IndexError):
                flash_bwd.build_causal_bwd_worklist(*args, **kw)
            continue
        got = flash_bwd.build_causal_bwd_worklist(*args, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), (args, kw)
        n += 1
    assert n > 500
    assert (flash_bwd.WL_INIT_DQ, flash_bwd.WL_WRITE_DQ, flash_bwd.WL_COMPUTE, flash_bwd.WL_MASK_GEN,
            flash_bwd.WL_INIT_KV, flash_bwd.WL_WRITE_KV, flash_bwd.WL_MASK_TRI) == (
        jb.WL_INIT_DQ, jb.WL_WRITE_DQ, jb.WL_COMPUTE, jb.WL_MASK_GEN, jb.WL_INIT_KV,
        jb.WL_WRITE_KV, jb.WL_MASK_TRI)


# ------------------------------ block partitions ----------------------------

# (Sq, Sk, shift, leaf, group, B, Hkv, head_dim): the Qwen trainer's 2 x 2047,
# the forced split's leaves of 2048 at S 4096, GQA, ragged last tiles and
# leaves, D 256's 64-row tiles, a small card-test shape.
TRI_SHAPES = [(2047, 2047, 0, 0, 1, 2, 32, 128), (4096, 4096, 0, 2048, 1, 1, 32, 128),
              (512, 512, 0, 0, 4, 2, 2, 128), (1000, 1000, 0, 384, 4, 2, 2, 64),
              (2047, 2047, 0, 0, 1, 1, 8, 256), (300, 300, 0, 0, 1, 2, 8, 128),
              (1024, 1536, 512, 0, 2, 1, 4, 64)]


def _wl_schedule(S, sub, block_kv, group=1, window=(-1, -1)):
    nq, nws, nsub_strip, tri_ok, dq_whole = flash_bwd._wl_geometry(S, S, group, 0, sub, block_kv)
    return (nq, sub, nws, nsub_strip, group, 0, window, True, tri_ok, dq_whole)


@pytest.mark.parametrize("shape", TRI_SHAPES)
def test_tri_partition_holds_every_kv_tile_once(shape):
    """B13's partition: for each leaf, P blocks whose ascending tile lists
    hold every kv tile of the leaf exactly once, paired t with n - 1 - t;
    the work per block is the (q tile, kv tile) pairs of its tiles."""
    Sq, Sk, shift, leaf, group, B, Hkv, D = shape
    P, starts, tiles, work = flash_bwd.tri_partition(*shape, flash_bwd.H100_SMS)
    bkv = flash_bwd.fused_kv_tile(D)
    spans = [(0, Sk)] if leaf == 0 else [(l0, min(l0 + leaf, Sk)) for l0 in range(0, Sq, leaf)]
    assert len(starts) == len(spans) * P + 1 and starts[0] == 0 and starts[-1] == len(tiles)
    for li, (c0, c1) in enumerate(spans):
        lists = [tiles[starts[x]:starts[x + 1]].tolist() for x in range(li * P, (li + 1) * P)]
        assert all(t == sorted(t) for t in lists)
        assert sorted(k0 for t in lists for k0 in t) == list(range(c0, c1, bkv))
        n = len(range(c0, c1, bkv))
        for t in lists:   # tiles come in mirrored pairs
            idx = sorted((k0 - c0) // bkv for k0 in t)
            assert sorted(n - 1 - i for i in idx) == sorted(idx)
    assert len(work) == len(spans) * P and sum(work) > 0


@pytest.mark.parametrize("schedule", [_wl_schedule(8191, 512, 2048), _wl_schedule(512, 128, None),
                                      _wl_schedule(1000, 128, 256),
                                      _wl_schedule(512, 64, 128, window=(200, -1)),
                                      _wl_schedule(512, 128, None, group=2)])
def test_wl_partition_holds_every_step_once(schedule):
    """B14's chunks: contiguous step ranges that cover the table once, each
    inside one strip, cut only between rows (a row's steps stay together);
    `firsts` gives each strip's chunks and `cover` its q-row blocks."""
    table, _ = flash_bwd._worklist(*schedule)
    S = schedule[0] * schedule[1]
    starts, firsts, cover, work = flash_bwd.wl_partition(schedule, S, S, 1, 2, 128,
                                                         flash_bwd.H100_SMS)
    assert starts[0] == 0 and starts[-1] == len(table) and np.all(np.diff(starts) > 0)
    rows = [tuple(r) for r in table[:, [4, 0, 1]].tolist()]   # (strip, g, iq)
    for a, b in zip(starts[:-1], starts[1:]):
        assert len({r[0] for r in rows[a:b]}) == 1
        assert a == 0 or rows[a] != rows[a - 1]
    strips = cover.shape[0]
    assert firsts[0] == 0 and firsts[-1] == len(starts) - 1 and len(firsts) == strips + 1
    for st in range(strips):
        chunk_strips = {int(table[starts[c], 4]) for c in range(firsts[st], firsts[st + 1])}
        assert chunk_strips <= {st}
        assert set(np.flatnonzero(cover[st])) == {r[2] for r in rows if r[0] == st}
    assert len(work) == len(starts) - 1


def test_partitions_fill_the_card_at_the_qwen_shapes():
    """At the Qwen1.5-7B trainer's shapes (32 / 32 heads, D 128) both
    kernels launch at least one block per SM of the H100 (132) and the
    largest block's work is within 1.25x the mean: the tri-square at 2 x
    2047, the forced split's diag leaves (2048) at 1 x 4096, the work list
    at 1 x 8191 (strips of 58 / 42 / 26 / 10 steps per head)."""
    sms = flash_bwd.H100_SMS
    for Sq, leaf, B in ((2047, 0, 2), (4096, 2048, 1)):
        P, starts, tiles, work = flash_bwd.tri_partition(Sq, Sq, 0, leaf, 1, B, 32, 128, sms)
        assert (len(starts) - 1) * 32 * B >= sms
        assert max(work) <= 1.25 * np.mean(work), work
    schedule = _wl_schedule(8191, 512, 2048)
    table, strip_starts = flash_bwd._worklist(*schedule)
    assert np.diff(strip_starts).tolist() == [58, 42, 26, 10]
    starts, _, _, work = flash_bwd.wl_partition(schedule, 8191, 8191, 1, 32, 128, sms)
    assert (len(starts) - 1) * 32 >= sms
    assert max(work) <= 1.25 * np.mean(work), work
    assert max(np.diff(starts)) < 58 / 2


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_partition_tiles_match_the_kernels(head_dim):
    """The partitions count in the 16-bit kernels' tiles: FUSED_BQ and
    fused_kv_tile are MmaCfg's BQ and BKV in csrc/bwd_mma.cuh, and both
    entry points take them as arguments (they refuse a partition built for
    other tiles)."""
    csrc = pathlib.Path(flash_bwd.__file__).resolve().parent.parent / "csrc"
    cfg = (csrc / "bwd_mma.cuh").read_text()
    lim, small_d, large_d = map(int, re.search(
        r"int BKV = D <= (\d+) \? (\d+) : (\d+);", cfg).groups())
    assert flash_bwd.fused_kv_tile(head_dim) == (small_d if head_dim <= lim else large_d)
    assert flash_bwd.FUSED_BQ == int(re.search(r"int BQ = (\d+);", cfg)[1])
    for name in ("flash_bwd_tri.cu", "flash_bwd_wl.cu"):
        src = (csrc / name).read_text()
        assert "int nparts, int tile_q, int tile_kv," in src
        assert "p.tile_q != C::BQ || p.tile_kv != C::BKV" in src


def test_twins_walk_the_partitions(monkeypatch):
    """The CPU twins take their block order from the partitions: a spy sees
    the tri-square twin ask `tri_partition` and the work-list twin ask
    `wl_partition`, at the shapes of the call and the H100's SM count."""
    seen = []
    for name in ("tri_partition", "wl_partition"):
        real = getattr(flash_bwd, name)
        monkeypatch.setattr(flash_bwd, name,
                            lambda *a, _real=real, _n=name: seen.append((_n, a)) or _real(*a))
    arrays = _inputs(1, 2, 2, 256, seed=4)
    q, k, v, do = (torch.from_numpy(x) for x in arrays[:4])
    lens = torch.tensor([[256, 256]], dtype=torch.int32)
    o, lse = flash_fwd.flash_attn_forward_plain(q, k, v, lens, causal=True, softmax_scale=SCALE)
    want = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, causal=True,
                                               softmax_scale=SCALE)
    _close(flash_bwd.flash_attn_backward_tri_square(q, k, v, do, o, lse, lens,
                                                    softmax_scale=SCALE), want)
    _close(flash_bwd.flash_attn_backward_fused_wl(q, k, v, do, o, lse, lens, softmax_scale=SCALE,
                                                  sub=64, block_kv=128), want, WL_TOL)
    assert [n for n, _ in seen] == ["tri_partition", "wl_partition"]
    assert seen[0][1] == (256, 256, 0, 0, 1, 1, 2, D, flash_bwd.H100_SMS)
    assert seen[1][1][1:] == (256, 256, 1, 2, D, flash_bwd.H100_SMS)


class _Routed(Exception):
    pass


def _recorder(route):
    def record(*args, **kwargs):
        raise _Routed(route)
    return record


def _jax_route(Sq, Sk, head_dim, nbytes, group, **g):
    """The schedule JAX's real `flash_attn_backward` dispatch takes, on
    zero-stride stand-ins of the arrays JAX's API pads to (its own block
    choice): its schedule entry points are stubs that record the route."""
    Dp = round_up_to_multiple(head_dim, 128)
    blocks = choose_block_sizes(Sq, Sk, Dp, dtype_bits=8 * nbytes, causal=g["causal"],
                                has_bias=False, has_window=g["window"] != (-1, -1),
                                has_varlen=g["varlen"])
    Sp = round_up_to_multiple(Sq, max(blocks.block_q, blocks.block_q_bwd))
    Skp = round_up_to_multiple(Sk, max(blocks.block_kv, blocks.block_kv_bwd))
    dt = jnp.bfloat16 if nbytes == 2 else jnp.float32
    zeros = lambda h, s: np.broadcast_to(np.zeros((), dt), (1, h, s, Dp))
    q, k = zeros(group, Sp), zeros(1, Skp)
    try:
        jb.flash_attn_backward(
            q, k, k, q, q, None, None, None, None, causal=g["causal"], softmax_scale=0.1,
            window=g["window"], softcap=g["softcap"], seqlen_q_real=Sq, seqlen_k_real=Sk,
            static_skip=g["static_skip"], varlen=g["varlen"], causal_split=g.get("causal_split"),
            split_leaf=g.get("split_leaf"))
    except _Routed as r:
        return r.args[0]
    except AssertionError:    # a forced split whose gate fails
        return "raises"
    raise AssertionError("JAX's dispatch reached no recorder")


def _port_route(Sq, Sk, head_dim, nbytes, group, **g):
    try:
        return flash_bwd.backward_route(
            Sq, Sk, head_dim, nbytes, causal=g["causal"], group=group,
            static_skip=g["static_skip"], window=g["window"], softcap=g["softcap"],
            varlen=g["varlen"], causal_split=g.get("causal_split"), split_leaf=g.get("split_leaf"))
    except ValueError:
        return "raises"


LENGTHS = [(100, 100), (511, 511), (2047, 2047), (2048, 2048), (2049, 2049), (3000, 3000),
           (4095, 4095), (6143, 6143), (7300, 7300), (8191, 8191), (12288, 12288),
           (16383, 16383), (2048, 4096), (4096, 8192), (1000, 1000), (24, 70)]


@pytest.fixture
def jax_recorders(monkeypatch):
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")
    for name, route in (("flash_attn_backward_tri_square", "tri_square"),
                        ("_causal_split_backward", "split"),
                        ("flash_attn_backward_causal_strip", "strip"),
                        ("flash_attn_backward_fused_wl", "worklist")):
        monkeypatch.setattr(jb, name, _recorder(route))
    # The fused (B2) and two-pass (B3) routes: both the dq + dk/dv pair here.
    monkeypatch.setattr(jtuning, "choose_fused_bwd", _recorder("generic"))
    return monkeypatch


def test_routes_match_jax(jax_recorders):
    """`backward_route` (what `flash_attn_backward` takes) equals the route
    of JAX's real dispatch at the shape JAX's API pads to, for every length,
    head dim, dtype size, GQA group and flag; then with the kill switches
    and a forced split (a failing one raises in both)."""
    seen = set()
    for (Sq, Sk), d, nbytes, group, f in itertools.product(LENGTHS, (64, 128, 256), (2, 4),
                                                           (1, 4), GATE_FLAGS):
        g = _flags(f)
        route = _port_route(Sq, Sk, d, nbytes, group, **g)
        assert route == _jax_route(Sq, Sk, d, nbytes, group, **g), (Sq, Sk, d, nbytes, group, f)
        seen.add(route)
    assert seen == {"tri_square", "strip", "worklist", "generic"}
    # The trainers' shapes and their neighbours: MHA, and Mistral's group of 4.
    plain = _flags({})
    for (S, group), want in {(2047, 1): "tri_square", (8191, 1): "worklist",
                             (6143, 1): "worklist", (2047, 4): "strip", (511, 4): "tri_square",
                             (4095, 1): "generic", (16383, 1): "generic"}.items():
        assert _port_route(S, S, 128, 2, group, **plain) == want == _jax_route(
            S, S, 128, 2, group, **plain), (S, group)
    for env, S, group, want in (("FA2_DISABLE_WL", 8191, 1, "generic"),
                                ("FA2_DISABLE_STRIP", 2047, 4, "generic"),
                                ("FA2_DISABLE_STRIP", 6143, 1, "worklist")):
        jax_recorders.setenv(env, "1")
        assert _port_route(S, S, 128, 2, group, **plain) == want == _jax_route(
            S, S, 128, 2, group, **plain), (env, S)
        jax_recorders.delenv(env)
    forced = [(4095, 1, dict(causal_split=True, split_leaf=2048)),   # two leaves: split
              (4095, 1, dict(causal_split=True)),                    # default: gate off, raises
              (4095, 1, dict(split_leaf=1024)),                      # a leaf alone routes
              (8191, 1, dict(causal_split=False, split_leaf=1024)),  # forced off
              (2047, 1, dict(causal_split=True, split_leaf=1024)),   # tri-square comes first
              (3000, 4, dict(causal_split=True, split_leaf=1024)),
              (4095, 4, dict(causal_split=True, split_leaf=100))]    # leaf below 128: raises
    for S, group, extra in forced:
        g = dict(plain, **extra)
        assert _port_route(S, S, 128, 2, group, **g) == _jax_route(S, S, 128, 2, group, **g), \
            (S, group, extra)
    assert _port_route(4095, 4095, 128, 2, 1, **dict(plain, causal_split=True)) == "raises"
    jax_recorders.setenv("FA2_DISABLE_SPLIT", "1")
    g = dict(plain, split_leaf=1024)
    assert _port_route(4095, 4095, 128, 2, 1, **g) == _jax_route(4095, 4095, 128, 2, 1, **g)
    # A bias, or fused=False, skips every schedule (JAX l.2189).
    assert flash_bwd.backward_route(2047, 2047, 128, 2, causal=True, static_skip=True,
                                    bias="bias") == "generic"
    assert flash_bwd.backward_route(2047, 2047, 128, 2, causal=True, static_skip=True,
                                    fused=False) == "generic"


# ------------------------------ the schedules ------------------------------

@pytest.mark.parametrize("Hkv,dropout_p", [(4, 0.0), (2, 0.2)])
def test_tri_square_matches_jax(Hkv, dropout_p):
    """B13 at S 512 with a dead tail (lens 450) and a dlse cotangent: the
    port's CPU path against JAX's tri-square launcher (sub 256)."""
    B, S, n = 2, 512, 450
    arrays = _inputs(B, 4, Hkv, S, seed=Hkv + int(10 * dropout_p))
    lens, scal, o, lse, dlse = _forward(arrays, B, n, dropout_p)
    kw = dict(softmax_scale=SCALE, dropout_p=dropout_p, seqlen_q_real=n, seqlen_k_real=n)
    j = jb.flash_attn_backward_tri_square(*(jnp.asarray(x) for x in arrays[:4]), jnp.asarray(o),
                                          jnp.asarray(lse), lens, scal, sub=256, dlse=dlse, **kw)
    q, k, v, do, to, tlse, tlens, tdlse = _torch(arrays, o, lse, dlse, B, n)
    t = flash_bwd.flash_attn_backward_tri_square(q, k, v, do, to, tlse, tlens, dlse=tdlse,
                                                 dropout_seed=SEED, **kw)
    _close(t, j)
    # flash_attn_backward routes this call to the same place.
    assert flash_bwd.backward_route(S, S, D, 2, causal=True, group=4 // Hkv, static_skip=True,
                                    seqlen_q_real=n, seqlen_k_real=n) == "tri_square"


def _split_case(n_leaves, Hkv, dropout_p):
    leaf, B = 128, 2
    S = leaf * n_leaves
    n_real = S - 50
    arrays = _inputs(B, 4, Hkv, S, seed=20 + n_leaves + Hkv)
    return arrays, B, S, n_real, _forward(arrays, B, n_real, dropout_p)


@pytest.mark.parametrize("n_leaves,Hkv,dropout_p", [(2, 4, 0.0), (3, 2, 0.3)])
def test_split_matches_jax(n_leaves, Hkv, dropout_p):
    """The split backward with leaves of 128 (one diag launch, one rect per
    causal_split_rects entry, added in fp32) against JAX's. Both are called
    directly: at these lengths both dispatches take the tri-square first
    (JAX l.2196), which the routing test covers."""
    arrays, B, S, n, (lens, scal, o, lse, dlse) = _split_case(n_leaves, Hkv, dropout_p)
    kw = dict(softmax_scale=SCALE, dropout_p=dropout_p, seqlen_q_real=n, seqlen_k_real=n)
    j = jb._causal_split_backward(*(jnp.asarray(x) for x in arrays[:4]), jnp.asarray(o),
                                  jnp.asarray(lse), lens, scal, leaf_t=128, dlse=dlse, **kw)
    q, k, v, do, to, tlse, tlens, tdlse = _torch(arrays, o, lse, dlse, B, n)
    t = flash_bwd._causal_split_backward(q, k, v, do, to, tlse, tlens, dlse=tdlse, leaf_t=128,
                                         dropout_seed=SEED, **kw)
    _close(t, j)


def test_diag_and_rect_match_jax():
    """The split's two launches alone, on JAX's prescaled k and global
    delta: every 128-row leaf (B13 diag, full-size outputs) and the
    rectangle rows [256, 384) x columns [0, 256) (B13 rect, region-sized)."""
    arrays, B, S, n, (lens, scal, o, lse, dlse) = _split_case(3, 2, 0.3)
    q, k, v, do = (jnp.asarray(x) for x in arrays[:4])
    k_p = (k * (SCALE * jb.LOG2E)).astype(k.dtype)
    delta = jnp.sum(jnp.asarray(o) * do, axis=-1, keepdims=True) - dlse * jb.LOG2E
    kw = dict(softmax_scale=SCALE, dropout_p=0.3, seqlen_q_real=n, seqlen_k_real=n)
    tq, tk, tv, tdo, _, tlse, tlens, _ = _torch(arrays, o, lse, dlse, B, n)
    tk_p, tdelta = torch.from_numpy(np.array(k_p)), torch.from_numpy(np.array(delta)[..., 0])
    j = jb.flash_attn_backward_causal_diag(q, k_p, v, do, jnp.asarray(lse), delta, lens, scal,
                                           T=128, sub=128, **kw)
    t = flash_bwd.flash_attn_backward_causal_diag(tq, tk_p, tv, tdo, tlse, tdelta, tlens, T=128,
                                                  dropout_seed=SEED, **kw)
    _close(t, j)
    region = dict(row0=256, col0=0, nrows=128, ncols=256)
    j = jb.flash_attn_backward_rect(q, k_p, v, do, jnp.asarray(lse), delta, lens, scal,
                                    block_q=128, block_kv=128, sub_kv=128, **region, **kw)
    t = flash_bwd.flash_attn_backward_rect(tq, tk_p, tv, tdo, tlse, tdelta, tlens,
                                           dropout_seed=SEED, **region, **kw)
    assert t[0].shape == (B, 4, 128, D) and t[1].shape == (B, 2, 256, D)
    _close(t, j)


WL_CASES = [dict(), dict(block_kv=256), dict(block_kv=256, n_real=450, dropout_p=0.1),
            dict(window=(200, -1)), dict(window=(200, -1), block_kv=256, n_real=450)]


@pytest.mark.parametrize("case", range(len(WL_CASES)))
def test_worklist_matches_jax(case):
    """B14's table-walking twin against JAX's work-list launcher (sub 128,
    S 512, MHA): one strip (the fold in the kernel, per-row dq), four strips
    of 128... (dq_whole), a padded tail with dropout, and a window."""
    c = dict(WL_CASES[case])
    B, S, n = 1, 512, c.pop("n_real", 512)
    dropout_p, window = c.pop("dropout_p", 0.0), c.pop("window", (-1, -1))
    arrays = _inputs(B, 2, 2, S, seed=40 + case)
    lens = jnp.broadcast_to(jnp.array([[n, n]], jnp.int32), (B, 2))
    scal = jnp.array([[0, 0, SEED, 0]], jnp.int32)
    q, k, v, do = (jnp.asarray(x) for x in arrays[:4])
    kw = dict(causal=True, softmax_scale=SCALE, window=window, dropout_p=dropout_p,
              seqlen_q_real=n, seqlen_k_real=n)
    o, lse = jf.flash_attn_forward(q, k, v, lens, scal, None, static_skip=True, block_q=128,
                                   block_kv=128, tri_square=False, causal_split=False,
                                   causal_strip=False, **kw)
    dlse = jnp.where(jnp.isfinite(lse), jnp.asarray(arrays[4])[..., None], 0.0)
    j = jb.flash_attn_backward_fused_wl(q, k, v, do, o, lse, lens, scal, sub=128, dlse=dlse,
                                        **c, **kw)
    tq, tk, tv, tdo, to, tlse, tlens, tdlse = _torch(arrays, np.asarray(o), np.asarray(lse), dlse,
                                                     B, n)
    t = flash_bwd.flash_attn_backward_fused_wl(tq, tk, tv, tdo, to, tlse, tlens, sub=128,
                                               dlse=tdlse, dropout_seed=SEED, **c, **kw)
    _close(t, j, WL_TOL)


def test_worklist_twin_reads_the_tables_flags(monkeypatch):
    """The twin honours the table: with every mask flag cleared it leaves the
    diagonal unmasked and the gradients move; with the real table they
    equal the plain backward."""
    arrays = _inputs(1, 2, 2, 256, seed=3)
    q, k, v, do = (torch.from_numpy(x) for x in arrays[:4])
    lens = torch.tensor([[256, 256]], dtype=torch.int32)
    o, lse = flash_fwd.flash_attn_forward_plain(q, k, v, lens, causal=True, softmax_scale=SCALE)
    kw = dict(softmax_scale=SCALE, sub=64, block_kv=128)
    got = flash_bwd.flash_attn_backward_fused_wl(q, k, v, do, o, lse, lens, **kw)
    want = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, causal=True,
                                               softmax_scale=SCALE)
    _close(got, want)
    real = flash_bwd._worklist

    def unmasked(*key):
        table, starts = real(*key)
        table = table.copy()
        table[:, 3] &= ~(flash_bwd.WL_MASK_GEN | flash_bwd.WL_MASK_TRI)
        return table, starts
    monkeypatch.setattr(flash_bwd, "_worklist", unmasked)
    bad = flash_bwd.flash_attn_backward_fused_wl(q, k, v, do, o, lse, lens, **kw)
    assert (bad[0] - want[0]).abs().max() > 1e-2


# ------------------------------ public path and preset ----------------------

def test_flash_attn_func_grads_match_jax_through_the_tri_square():
    """flash_attn_func forward + backward on the CPU against jax.grad of
    JAX's, MHA 4 / 4 heads at S 250 (padded 256: inside the tri-square
    gate on both sides), with an lse cotangent."""
    assert flash_bwd.backward_route(250, 250, D, 4, causal=True, static_skip=True) == \
        "tri_square"
    rng = np.random.RandomState(9)
    q, k, v = (rng.normal(0, 0.5, (2, 250, 4, D)).astype(np.float32) for _ in range(3))
    do = rng.normal(0, 1, (2, 250, 4, D)).astype(np.float32)
    dl = rng.normal(0, 0.1, (2, 4, 250)).astype(np.float32)

    def jloss(q, k, v):
        out, lse = jfa.flash_attn_func(q, k, v, causal=True, return_lse=True)
        return jnp.sum(out * do) + jnp.sum(lse * dl)
    j = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attn_func(*leaves, causal=True, return_lse=True)
    ((out * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dl)).sum()).backward()
    _close([x.grad for x in leaves], j)


# Qwen1.5-7B's published config.json
# (https://huggingface.co/Qwen/Qwen1.5-7B/blob/main/config.json), written out.
QWEN_HF = dict(
    architectures=["Qwen2ForCausalLM"], hidden_act="silu", hidden_size=4096,
    intermediate_size=11008, max_position_embeddings=32768, max_window_layers=28,
    model_type="qwen2", num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=32,
    rms_norm_eps=1e-6, rope_theta=1000000.0, sliding_window=32768, tie_word_embeddings=False,
    use_sliding_window=False, vocab_size=151936)


def test_qwen_preset_matches_jax_config_from_hf():
    """preset_config("qwen1.5-7b") against JAX's llama_config_from_hf on the
    published values, field by field. Qwen2's q/k/v biases are implied by
    its architecture: JAX reads them off the state dict (llama_params_from_hf
    sets qkv_bias from "q_proj.bias"), so its config from the values alone
    gets qkv_bias=True the same way here."""
    want = dataclasses.replace(
        jconvert.llama_config_from_hf(types.SimpleNamespace(**QWEN_HF)), qkv_bias=True)
    got = ttrain.preset_config("qwen1.5-7b")
    names = {f.name for f in dataclasses.fields(tl.LlamaConfig)} & {
        f.name for f in dataclasses.fields(jl.LlamaConfig)}
    assert names >= {"vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
                     "head_dim", "rope_theta", "norm_eps", "max_seq_len", "sliding_window",
                     "qkv_bias", "window_pattern", "rope_factors"}
    for name in sorted(names - {"dtype", "remat"}):
        assert getattr(got, name) == getattr(want, name), name
    assert got.dtype == torch.bfloat16 and got.n_heads == got.n_kv_heads == 32


def test_qwen_shaped_model_loss_and_grads_match_jax():
    """A 2-layer, narrow Qwen-shaped model (MHA, q/k/v biases set nonzero,
    RoPE 1e6, eps 1e-6): loss_fn and every parameter gradient against JAX's,
    fp32, 1e-5 (tests/test_torch_train.py's tolerance)."""
    widths = dict(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=4, hidden_dim=344,
                  max_seq_len=256, rope_theta=1e6, norm_eps=1e-6, qkv_bias=True)
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **widths)
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.RandomState(2)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            layer[name] = rng.normal(0, 0.1, layer[name].shape).astype(np.float32)
    tokens = rng.randint(0, 128, size=(2, 41)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(jl.loss_fn)(jax.tree.map(jnp.asarray, params),
                                                     jnp.asarray(tokens), jcfg)
    model = llama_from_jax_params(params, tl.LlamaConfig(dtype=torch.float32, **widths),
                                  device="cpu")
    loss = tl.loss_fn(model, torch.from_numpy(tokens).long())
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= TOL
    t_grads = llama_to_jax_params(model, grads=True)
    leaves_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, j_grads)))
    leaves_t = jax.tree_util.tree_leaves_with_path(t_grads)
    assert len(leaves_t) == len(leaves_j) and any("bq" in jax.tree_util.keystr(p)
                                                  for p, _ in leaves_t)
    for path, a in leaves_t:
        np.testing.assert_allclose(a, leaves_j[path], rtol=0, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
