"""Gradients of the port's `flash_attn_func` (the plain backward twin on the
CPU, through `_AttnCore`) against `jax.grad` of the JAX `flash_attn_func`
(Pallas kernels in interpret mode), fp32, on the same numpy-seeded inputs.

The shapes pick the JAX backward routes the port's kernels replace: a
padded causal GQA batch at S=300 and the window / softcap / lse-cotangent
cases at S=130 reach B2 (`_bwd_fused_kernel`); every bias case reaches B3
(`_dq_kernel`, `_dkdv_kernel`) and B4 (`_dbias_kernel`); B12
(`_bwd_causal_strip_kernel`, the seq-2048 training route) is called
directly at the smallest shape it takes (Sq = Sk = 1024, sub = 512).

Tolerance 1e-5 max abs on every gradient: both sides compute in fp32, so
only the summation order differs (gradients here are O(1), sums of up to
a few hundred products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.ops import flash_bwd as jbwd

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

TOL = 1e-5


def _data(S, seed, B=2, Hq=4, Hkv=2, D=64):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 0.5, (B, S, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    do = rng.normal(0, 1.0, (B, S, Hq, D)).astype(np.float32)
    return rng, q, k, v, do


def _grads_both(q, k, v, do, bias=None, mask=None, dlse=None, **kw):
    """(jax grads, torch grads) of sum(out * do) [+ sum(lse * dlse)] w.r.t.
    q, k, v and the bias when given."""
    j_mask = None if mask is None else jnp.asarray(mask)
    n = 4 if bias is not None else 3

    def jloss(q, k, v, b):
        out, lse = jfa.flash_attn_func(q, k, v, attention_mask=j_mask, attention_bias=b,
                                       return_lse=True, **kw)
        val = jnp.sum(out * jnp.asarray(do))
        if dlse is not None:
            val = val + jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * jnp.asarray(dlse))
        return val

    jb = None if bias is None else jnp.asarray(bias)
    jg = jax.grad(jloss, argnums=tuple(range(n)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v) + ((bias,) if bias is not None else ())]
    out, lse = flash_attn_func(*leaves[:3], attention_bias=leaves[3] if bias is not None else None,
                               attention_mask=None if mask is None else torch.from_numpy(mask),
                               return_lse=True, **kw)
    val = (out * torch.from_numpy(do)).sum()
    if dlse is not None:
        val = val + (torch.where(torch.isfinite(lse), lse, 0.0) * torch.from_numpy(dlse)).sum()
    val.backward()
    return [np.asarray(g) for g in jg], [x.grad.numpy() for x in leaves]


def _assert_close(jg, tg):
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), jg, tg):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=name)


def test_causal_gqa_ragged_mask_grads_match_jax():
    _, q, k, v, do = _data(300, 0)
    mask = np.arange(300)[None] < np.array([300, 171])[:, None]
    _assert_close(*_grads_both(q, k, v, do, mask=mask, causal=True))


@pytest.mark.parametrize("kw", [dict(causal=True, window_size=(16, 0)),
                                dict(causal=False, window_size=(8, 8)),
                                dict(causal=True, softcap=5.0)])
def test_window_and_softcap_grads_match_jax(kw):
    _, q, k, v, do = _data(130, 1)
    _assert_close(*_grads_both(q, k, v, do, **kw))


@pytest.mark.parametrize("shape", [(1, 1, 96, 96), (2, 1, 96, 96), (2, 4, 96, 96)])
def test_bias_grads_and_dbias_match_jax(shape):
    rng, q, k, v, do = _data(96, 2)
    bias = rng.normal(0, 1.0, shape).astype(np.float32)
    jg, tg = _grads_both(q, k, v, do, bias=bias, causal=True)
    assert len(tg) == 4 and tg[3].shape == shape
    _assert_close(jg, tg)


@pytest.mark.parametrize("shape,hkv,kw", [
    ((1, 4, 96, 96), 2, dict(causal=True, window_size=(16, 0))),   # a window: dead tiles left of it
    ((1, 4, 96, 96), 2, dict(causal=False, softcap=5.0)),          # ds before softcap's chain rule
    ((2, 1, 96, 96), 1, dict(causal=True)),                        # summed over a GQA group of 4
])
def test_dbias_element_rules_match_jax(shape, hkv, kw):
    """The element rules the dbias kernels keep (B4 `_dbias_kernel`): a bias
    under a sliding window, a bias beside softcap, and a [B, 1, S, S] bias
    summed over the q heads of a GQA group of 4."""
    rng, q, k, v, do = _data(96, 6, Hkv=hkv)
    bias = rng.normal(0, 1.0, shape).astype(np.float32)
    jg, tg = _grads_both(q, k, v, do, bias=bias, **kw)
    assert len(tg) == 4 and tg[3].shape == shape
    _assert_close(jg, tg)


def test_lse_cotangent_folds_into_delta():
    rng, q, k, v, do = _data(130, 3)
    dlse = rng.normal(0, 1.0, (2, 4, 130)).astype(np.float32)
    jg, tg = _grads_both(q, k, v, do, dlse=dlse, causal=True)
    _assert_close(jg, tg)
    # The lse cotangent changes dq / dk (not dv): the fold is really taken.
    jg0, _ = _grads_both(q, k, v, do, causal=True)
    assert np.abs(jg[0] - jg0[0]).max() > 1e-3


def test_b12_causal_strip_matches_plain_backward():
    """The TPU's whole-strip causal backward (B12) called directly at its
    smallest shape, on o / lse from the port's plain forward, against the
    port's `flash_attn_backward` (the plain twin on the CPU)."""
    B, Hq, Hkv, S, D = 1, 2, 1, 1024, 128
    rng = np.random.RandomState(4)
    q, do = (rng.normal(0, s, (B, Hq, S, D)).astype(np.float32) for s in (0.5, 1.0))
    k, v = (rng.normal(0, 0.5, (B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    lens = np.array([[S, S]], np.int32)
    scale = D ** -0.5
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = flash_fwd.flash_attn_forward(*t[:3], torch.from_numpy(lens), causal=True,
                                          softmax_scale=scale)
    tg = flash_bwd.flash_attn_backward(*t, o, lse, torch.from_numpy(lens), causal=True,
                                       softmax_scale=scale)
    jg = jbwd.flash_attn_backward_causal_strip(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do),
        jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()[..., None]), jnp.asarray(lens),
        jnp.zeros((1, 4), jnp.int32), softmax_scale=scale, sub=512)
    for name, a, b in zip(("dq", "dk", "dv"), jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL, err_msg=name)


def test_backward_plain_gives_dead_rows_zero_gradient():
    """Rows with no valid column (lse = -inf) get exactly zero dq, and NaN
    in padding cannot leak into any gradient."""
    rng, q, k, v, do = _data(40, 5)
    bhsd = lambda x: torch.from_numpy(x).transpose(1, 2)
    q, k, v, do = (bhsd(x) for x in (q, k, v, do))
    lens = torch.tensor([[40, 40], [25, 25]], dtype=torch.int32)
    kw = dict(causal=True, softmax_scale=0.125)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
    base = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw)
    for x in (q, k, v, do):
        x[1, :, 25:] = float("nan")
    grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw)
    for g, ref in zip(grads, base):
        assert torch.isfinite(g).all()
        assert not g[1, :, 25:].any()
        torch.testing.assert_close(g, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_wrapper_passes_the_kernels_tile_rows(monkeypatch, dtype):
    """The dq kernels (FMA `dq_kernel`, tensor-core `dq_mma_kernel`) own q
    tiles of TM rows (csrc/attn_tiles.cuh), the count the host's TILE_ROWS
    assumes: the wrapper hands TILE_ROWS to `fa2_flash_bwd` just before the
    stream, for the dq and the dk/dv launch, and the entry point refuses any
    other value. Recorded through a stand-in entry point (no build, no
    GPU), with one argument per argtype."""
    import pathlib
    import re

    csrc = pathlib.Path(flash_bwd.__file__).resolve().parent.parent / "csrc"
    tm = int(re.search(r"constexpr int TM = (\d+);", (csrc / "attn_tiles.cuh").read_text())[1])
    src = (csrc / "flash_bwd.cu").read_text()
    tiles = (csrc / "bwd_mma.cuh").read_text()    # DqMmaCfg: the dq kernels' tiles
    dq_cfg = tiles[tiles.index("struct DqMmaCfg"):tiles.index("};", tiles.index("struct DqMmaCfg"))]
    assert "static constexpr int BQ = TM;" in dq_cfg
    assert "int k_prescaled, int tile_rows, void* stream)" in src
    assert "if (p.tile_rows != TM ||" in src
    assert flash_fwd.TILE_ROWS == tm

    calls = []
    monkeypatch.setattr(flash_bwd, "_entry", lambda name="fa2_flash_bwd": lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(flash_bwd._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(flash_bwd, "LAUNCHES", dict.fromkeys(flash_bwd.LAUNCHES, 0))
    _, q, k, v, do = _data(70, 5)
    q, k, v, do = (torch.from_numpy(x).to(dtype).transpose(1, 2) for x in (q, k, v, do))
    lse = torch.zeros(q.shape[:3])
    lens = torch.tensor([[70, 70], [70, 70]], dtype=torch.int32)
    flash_bwd._pair_backward(q, k, v, do, lse, lse, lens, 0, 0, None, causal=True,
                             softmax_scale=0.125, window=(-1, -1), softcap=0.0,
                             compute_dbias=False, dropout_p=0.0, dropout_seed=0,
                             seqlen_q_real=None, seqlen_k_real=None)
    assert [c[0] for c in calls] == [0, 1]    # dq, then dk/dv
    for c in calls:
        assert len(c) == len(flash_bwd._ARGTYPES["fa2_flash_bwd"])
        assert c[-2] == tm
