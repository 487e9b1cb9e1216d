"""Packed varlen and block-sparse attention of the port (`ops/varlen.py`,
the plain twins on the CPU, through `_VarlenCore`) against the JAX package's
`fa2_triton_tpu/ops/varlen.py` (Pallas B7 / B8 kernels in interpret mode),
on the same numpy-seeded inputs.

Tolerance: outputs (o, base-2 lse) 2e-5 and gradients 5e-5 max abs, in
fp32: the JAX package's own bounds for this path
(`tests/test_varlen_packed.py:65-68`). Both sides compute in fp32, so only
the summation order differs. The host schedule, the mask encoding and the
packing are compared bitwise: they are exact integer / copy work.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.ops import varlen as jvarlen

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import flash_attn_reference, varlen  # noqa: E402

OUT_TOL, GRAD_TOL = 2e-5, 5e-5


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    fin = np.isfinite(b)
    err = np.abs(a[fin] - b[fin]).max() if fin.any() else 0.0
    assert err <= tol, (what, err)


# --------------------------- host layout, bitwise --------------------------

SCHEDULES = {
    "dense": dict(starts=[0, 512, 1024], T=1536, qlens=(300, 512, 129), kvlens=(300, 512, 129),
                  blocks=(128, 128)),
    "rect": dict(starts=[0, 512, 1024], T=1536, qlens=(300, 512, 129), kvlens=(300, 512, 129),
                 blocks=(128, 256)),
    "len1": dict(starts=[0, 512, 768], T=1024, qlens=(512, 1, 200), kvlens=(512, 1, 200),
                 blocks=(256, 128)),
    "qlen_ne_kvlen": dict(starts=[0, 512, 768], T=1280, qlens=(300, 1, 200),
                          kvlens=(200, 64, 449), blocks=(128, 256)),
    "block_mask": dict(starts=[0, 512], T=1024, qlens=(512, 400), kvlens=(512, 400),
                       blocks=(128, 128), mask=True),
}


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("kv_major", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_build_schedule_is_bitwise_jax(name, causal, kv_major, group):
    c = SCHEDULES[name]
    keep = None
    if c.get("mask"):
        bits = np.random.RandomState(1).rand(4, 4) < 0.5
        keep = lambda s, jq, jk: bool(bits[jq, jk])  # noqa: E731
    args = (c["starts"], jvarlen._seg_extents(c["starts"], c["T"]), c["qlens"], c["kvlens"],
            *c["blocks"], causal)
    kw = dict(kv_major=kv_major, group=group, keep_block=keep)
    assert varlen._seg_extents(c["starts"], c["T"]) == args[1]
    want = jvarlen._build_schedule(*args, **kw)
    got = varlen._build_schedule(*args, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_block_mask_encoding_and_packing_are_bitwise_jax():
    rng = np.random.RandomState(2)
    for shape in ((4, 4), (2, 4), (3, 1)):
        m = rng.rand(*shape) < 0.5
        enc = varlen.encode_block_mask(m)
        assert enc == jvarlen.encode_block_mask(m)
        kt, kj = varlen._mask_keep_fn(enc), jvarlen._mask_keep_fn(enc)
        assert all(kt(0, i, j) == kj(0, i, j) == m[i, j]
                   for i in range(shape[0]) for j in range(shape[1]))
    assert varlen._mask_keep_fn(None) is None

    lens = (300, 1, 129)
    x = rng.normal(size=(3, 300, 2, 8)).astype(np.float32)
    y = rng.normal(size=(3, 300, 4)).astype(np.float32)
    (jx, jy), jstarts, jT = jfa.pack_padded_batch([jnp.asarray(x), jnp.asarray(y)], lens, align=128)
    (tx, ty), tstarts, tT = varlen.pack_padded_batch([torch.from_numpy(x), torch.from_numpy(y)],
                                                     lens, align=128)
    assert tT == jT and np.array_equal(tstarts, jstarts) and tstarts.dtype == jstarts.dtype
    assert np.array_equal(tx.numpy(), np.asarray(jx)) and np.array_equal(ty.numpy(), np.asarray(jy))
    back_t = varlen.unpack_padded_batch(tx, tstarts, lens, 300)
    back_j = jfa.unpack_padded_batch(jx, jstarts, lens, 300)
    assert np.array_equal(back_t.numpy(), np.asarray(back_j))


# ------------------------- flash_attn_varlen_func -------------------------

def _packed_inputs(T, Hq, Hkv, D, seed):
    """Random packed q / k / v / do over the whole stream: the gaps between
    segments hold nonzero values, which must not reach any live output."""
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 0.5, (1, T, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (1, T, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (1, T, Hkv, D)).astype(np.float32)
    do = rng.normal(0, 0.5, (1, T, Hq, D)).astype(np.float32)
    dl = rng.normal(0, 1.0, (1, Hq, T)).astype(np.float32)
    return q, k, v, do, dl


def _torch_fwd_bwd(fn, q, k, v, do, dl):
    """out, lse and (dq, dk, dv) of sum(out * do) + sum(finite lse * dl)."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = fn(*leaves)
    loss = (out * torch.from_numpy(do)).sum()
    loss = loss + (torch.where(torch.isfinite(lse), lse, 0.0) * torch.from_numpy(dl)).sum()
    loss.backward()
    return out.detach().numpy(), lse.detach().numpy(), [x.grad.numpy() for x in leaves]


def _jax_fwd_bwd(fn, q, k, v, do, dl):
    (out, lse), vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp((jnp.asarray(do), jnp.asarray(dl)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blocks", [(128, 128), (128, 256)])
@pytest.mark.parametrize("lens", [(300, 512, 129), (512, 1, 200)])
def test_varlen_func_fwd_bwd_matches_jax(lens, blocks, causal):
    Hq, Hkv, D = 4, 2, 64
    starts = np.cumsum([0] + [-(-max(l, 1) // max(blocks)) * max(blocks) for l in lens[:-1]])
    T = int(starts[-1]) + -(-lens[-1] // max(blocks)) * max(blocks)
    cu = [int(s) for s in starts] + [T]
    q, k, v, do, dl = _packed_inputs(T, Hq, Hkv, D, seed=sum(lens) + blocks[1] + causal)
    kw = dict(seqlens=lens, causal=causal, block_q=blocks[0], block_kv=blocks[1], return_lse=True)
    j_out, j_lse, j_grads = _jax_fwd_bwd(
        lambda a, b, c: jfa.flash_attn_varlen_func(a, b, c, cu, **kw), q, k, v, do, dl)
    t_out, t_lse, t_grads = _torch_fwd_bwd(
        lambda a, b, c: varlen.flash_attn_varlen_func(a, b, c, cu, **kw), q, k, v, do, dl)
    _close(t_out, j_out, OUT_TOL, "o")
    _close(t_lse, j_lse, OUT_TOL, "lse")
    live = np.zeros(T, bool)
    for s0, l in zip(starts, lens):
        live[int(s0):int(s0) + l] = True
    assert not t_out[0, ~live].any() and np.all(t_lse[:, :, ~live] == -np.inf)
    for name, tg, jg in zip(("dq", "dk", "dv"), t_grads, j_grads):
        _close(tg, jg, GRAD_TOL, name)
        assert not tg[0, ~live].any(), f"{name}: packed dead positions must be exactly 0"


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_launchers_with_q_len_ne_kv_len_match_jax(causal):
    """The launchers take q and kv lengths apart (bottom-right causal
    alignment on each segment's own shift); the public API passes them
    equal."""
    c = SCHEDULES["qlen_ne_kvlen"]
    T, (bq, bkv) = c["T"], c["blocks"]
    q, k, v, do, dl = (x.transpose(0, 2, 1, 3) if x.ndim == 4 else x
                       for x in _packed_inputs(T, 4, 2, 64, seed=7 + causal))
    kw = dict(causal=causal, softmax_scale=0.125, block_q=bq, block_kv=bkv)
    starts = np.asarray(c["starts"], np.int32)
    j_o, j_lse = jvarlen.flash_attn_varlen_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), starts, c["qlens"], c["kvlens"], **kw)
    j_dlse = jnp.asarray(dl)[..., None]
    j_grads = jvarlen.flash_attn_varlen_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do), j_o, j_lse, starts,
        c["qlens"], c["kvlens"], dlse=jnp.where(jnp.isfinite(j_lse), j_dlse, 0.0), **kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_o, t_lse = varlen.flash_attn_varlen_forward(tq, tk, tv, starts, c["qlens"], c["kvlens"], **kw)
    t_grads = varlen.flash_attn_varlen_backward(tq, tk, tv, tdo, t_o, t_lse, starts, c["qlens"],
                                                c["kvlens"], dlse=torch.from_numpy(dl), **kw)
    _close(t_o.numpy(), np.asarray(j_o), OUT_TOL, "o")
    _close(t_lse.numpy(), np.asarray(j_lse)[..., 0], OUT_TOL, "lse")
    for name, tg, jg in zip(("dq", "dk", "dv"), t_grads, j_grads):
        _close(tg.numpy(), np.asarray(jg), GRAD_TOL, name)


# ---------------------- flash_attn_blocksparse_func -----------------------

def _bs_inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 0.5, (B, S, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    do = rng.normal(0, 0.5, (B, S, Hq, D)).astype(np.float32)
    dl = rng.normal(0, 1.0, (B, Hq, S)).astype(np.float32)
    return q, k, v, do, dl


def _bs_both(mask, causal, inputs, bq=128, bkv=128):
    kw = dict(causal=causal, block_q=bq, block_kv=bkv, return_lse=True)
    j = _jax_fwd_bwd(lambda a, b, c: jfa.flash_attn_blocksparse_func(a, b, c, mask, **kw), *inputs)
    t = _torch_fwd_bwd(lambda a, b, c: varlen.flash_attn_blocksparse_func(a, b, c, mask, **kw),
                       *inputs)
    return j, t


@pytest.mark.parametrize("causal", [False, True])
def test_blocksparse_fwd_bwd_matches_jax(causal):
    rng = np.random.RandomState(0)            # the mask of tests/test_blocksparse.py:53-56
    mask = rng.rand(4, 4) < 0.6
    mask[:, 0] = True
    np.fill_diagonal(mask, True)
    (j_out, j_lse, j_grads), (t_out, t_lse, t_grads) = _bs_both(
        mask, causal, _bs_inputs(2, 512, 4, 2, 64, seed=10 + causal))
    _close(t_out, j_out, OUT_TOL, "o")
    _close(t_lse, j_lse, OUT_TOL, "lse")
    for name, tg, jg in zip(("dq", "dk", "dv"), t_grads, j_grads):
        _close(tg, jg, GRAD_TOL, name)


def test_blocksparse_fully_filtered_row_and_kv_block_match_jax():
    """q block 1 keeps no kv block and kv block 2 is kept by no q block:
    zeros and lse = -inf on those rows, zero dq there and zero dk / dv on
    those columns (a live kv block filtered out must not pick up another
    q block's p or ds)."""
    mask = np.ones((4, 4), bool)
    mask[1, :] = False
    mask[:, 2] = False
    inputs = _bs_inputs(1, 512, 2, 2, 64, seed=3)
    (j_out, j_lse, j_grads), (t_out, t_lse, t_grads) = _bs_both(mask, False, inputs)
    _close(t_out, j_out, OUT_TOL, "o")
    _close(t_lse, j_lse, OUT_TOL, "lse")
    for name, tg, jg in zip(("dq", "dk", "dv"), t_grads, j_grads):
        _close(tg, jg, GRAD_TOL, name)
    rows = slice(128, 256)
    assert not t_out[:, rows].any() and np.all(t_lse[:, :, rows] == -np.inf)
    assert not t_grads[0][:, rows].any()
    assert not t_grads[1][:, 256:384].any() and not t_grads[2][:, 256:384].any()


def test_blocksparse_rows_with_no_kept_causal_column_match_the_oracle():
    """Causal, block_q 256 > block_kv 128, mask [[False, True]]: rows 0-127
    keep no column (their one kept kv block lies above the diagonal), so
    they must give o = 0 and lse = -inf with zero gradients, as the
    function's contract and the dense oracle say. The JAX kernel masks with
    a finite -1e30 and averages v on those rows instead (ROADMAP.md queue
    C), so this case is held against the port's plain attention oracle
    (`flash_attn_reference` with a -inf bias), not against JAX."""
    S, D = 256, 64
    mask = np.array([[False, True]])
    q, k, v, do, _ = _bs_inputs(1, S, 2, 1, D, seed=4)
    elem = np.repeat(mask, 128, axis=1)[np.arange(S) // 256] & np.tril(np.ones((S, S), bool))
    bias = torch.from_numpy(np.where(elem, 0.0, -np.inf).astype(np.float32))[None, None]
    outs = []
    for fn in (lambda a, b, c: varlen.flash_attn_blocksparse_func(
                   a, b, c, mask, causal=True, block_q=256, block_kv=128, return_lse=True),
               lambda a, b, c: flash_attn_reference(a, b, c, attn_bias=bias, return_lse=True)):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out, lse = fn(*leaves)
        (out * torch.from_numpy(do)).sum().backward()
        outs.append((out.detach().numpy(), lse.detach().numpy(), [x.grad.numpy() for x in leaves]))
    (t_out, t_lse, t_grads), (r_out, r_lse, r_grads) = outs
    assert not t_out[:, :128].any() and np.all(t_lse[:, :, :128] == -np.inf)
    assert not t_grads[0][:, :128].any()
    _close(t_out, r_out, OUT_TOL, "o")
    _close(t_lse, r_lse, OUT_TOL, "lse")
    for name, tg, rg in zip(("dq", "dk", "dv"), t_grads, r_grads):
        _close(tg, rg, GRAD_TOL, name)


def test_dropout_and_bad_layouts_raise():
    x = torch.zeros(256, 2, 64)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        varlen.flash_attn_varlen_func(x, x, x, [0, 256], dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        varlen.flash_attn_blocksparse_func(x[None], x[None], x[None], np.ones((1, 1), bool),
                                           block_q=256, block_kv=256, dropout_p=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        varlen.flash_attn_varlen_func(x, x, x, [0, 256], dropout_p=1.0, dropout_seed=3)
    with pytest.raises(ValueError, match="aligned"):
        varlen.flash_attn_varlen_func(x, x, x, [0, 100, 256], block_q=128, block_kv=128)
    with pytest.raises(ValueError, match="block_mask"):
        varlen.flash_attn_blocksparse_func(x[None], x[None], x[None], np.ones((2, 2), bool),
                                           block_q=256, block_kv=256)
