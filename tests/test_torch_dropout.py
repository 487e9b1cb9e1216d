"""Attention dropout of the port against the JAX package, on the CPU.

1. `utils/rng.py` bit for bit against `fa2_triton_tpu/utils/rng.py`: the
   counter hash (counters >= 2**31, negative seeds), the threshold, the
   counter grid, the dense keep mask at global offsets with counters that
   wrap 2**32, and the chained packed mask of JAX
   `ops/varlen.py:_packed_dropout_bits`.
2. `flash_attn_func(dropout_p > 0, dropout_seed=...)`: output, base-2 lse
   and gradients (the plain twins on the CPU, through `_AttnCore`) against
   the JAX `flash_attn_func` (Pallas in interpret mode) with the same seed,
   fp32, 1e-5 max abs (only the summation order differs). The lengths reach
   the JAX routes the kernels replace: S 100 -> one B1 block, 300 -> B1
   multi-block with the B2 backward, 512 -> B9, a bias -> B3 / B4, and B12
   called directly at its smallest shape.
3. `flash_attn_varlen_func` / `flash_attn_blocksparse_func` with dropout
   against JAX's: outputs 2e-5, gradients 5e-5 (`tests/test_torch_varlen.py`'s
   bounds).
4. The seed contract: `dropout_rng` (a CPU torch.Generator) gives the same
   output from the same state and another from another; JAX derives its
   seed with threefry, so the generator path is held to its own contract,
   not to JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.ops import flash_bwd as jbwd
from fa2_triton_tpu.utils import rng as jrng

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd, varlen  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402
from fa2_triton_tpu_torch.utils import rng as trng  # noqa: E402

TOL = 1e-5
VARLEN_OUT_TOL, VARLEN_GRAD_TOL = 2e-5, 5e-5


# ------------------------------- utils/rng.py -------------------------------

def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, -1, -2**31, 2**31 - 1, 12345, -777])
def test_counter_hash_is_bitwise_jax(seed):
    rng = np.random.RandomState(0)
    counters = np.concatenate([rng.randint(0, 2**32, 4000, dtype=np.uint64),
                               [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1]]).astype(np.uint32)
    want = jrng.counter_hash_uint32(jnp.asarray(seed, jnp.int32), jnp.asarray(counters))
    got = trng.counter_hash_uint32(seed, torch.from_numpy(counters.astype(np.int64)))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), _u32(want))


def test_threshold_offsets_and_reference_mask_are_bitwise_jax():
    for p in (0.0, 1e-12, 0.1, 0.5, 0.999999, 1.0):
        assert trng.dropout_threshold(p) == jrng.dropout_threshold(p)
    assert np.array_equal(trng.dropout_offsets(3, 5, 70, 90).numpy(),
                          _u32(jrng.dropout_offsets(3, 5, 70, 90)))
    for seed in (0, 9, -5):
        want = jrng.dropout_keep_mask_reference(seed & 0xFFFFFFFF, 0.3, 2, 3, 40, 50)
        got = trng.dropout_keep_mask_reference(seed, 0.3, 2, 3, 40, 50)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert 0.65 < got.float().mean().item() < 0.75


def test_keep_mask_at_offsets_wraps_like_jax():
    """A call's rows at q_off and columns at kv_off of a long sequence, with
    counters past 2**32 (real lengths 70000 x 70000 over 3 heads): the
    counter wraps mod 2**32 as JAX's uint32 arithmetic does."""
    B, H, Sq_real, Sk_real, seed, p = 2, 3, 70000, 70000, -123, 0.25
    rows = np.arange(69950, 70000)
    cols = np.concatenate([np.arange(0, 20), np.arange(69970, 70000)])
    b = jnp.arange(B, dtype=jnp.uint32).reshape(-1, 1, 1, 1)
    h = jnp.arange(H, dtype=jnp.uint32).reshape(1, -1, 1, 1)
    i = jnp.asarray(rows, jnp.uint32).reshape(1, 1, -1, 1)
    j = jnp.asarray(cols, jnp.uint32).reshape(1, 1, 1, -1)
    flat = ((b * jnp.uint32(H) + h) * jnp.uint32(Sq_real) + i) * jnp.uint32(Sk_real) + j
    want = jrng.counter_hash_uint32(jnp.asarray(seed, jnp.int32), flat) >= \
        jnp.uint32(jrng.dropout_threshold(p))
    got = trng.dropout_keep_mask(seed, p, B, H, torch.from_numpy(rows), torch.from_numpy(cols),
                                 Sq_real, Sk_real)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_packed_mask_is_bitwise_jax():
    """hash(hash(hash(seed, h), row), col) over global packed coordinates
    (JAX `_packed_dropout_bits`)."""
    seed, p = -2**31 + 5, 0.4
    heads, rows, cols = np.arange(4), np.arange(1000, 1100), np.arange(900, 1100)
    u = lambda x: jnp.asarray(x, jnp.uint32)  # noqa: E731
    s_h = jrng.counter_hash_uint32(jnp.asarray(seed, jnp.int32).astype(jnp.uint32),
                                   u(heads).reshape(-1, 1, 1))
    bits = jrng.counter_hash_uint32(jrng.counter_hash_uint32(s_h, u(rows).reshape(1, -1, 1)),
                                    u(cols).reshape(1, 1, -1))
    want = bits >= jnp.uint32(jrng.dropout_threshold(p))
    got = trng.packed_dropout_keep_mask(seed, p, *(torch.from_numpy(x) for x in (heads, rows, cols)))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ----------------------------- flash_attn_func ------------------------------

def _data(S, seed, B=2, Hq=4, Hkv=2, D=64):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 0.5, (B, S, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    do = rng.normal(0, 1.0, (B, S, Hq, D)).astype(np.float32)
    dl = rng.normal(0, 1.0, (B, Hq, S)).astype(np.float32)
    return rng, q, k, v, do, dl


def _both(q, k, v, do, dl, bias=None, mask=None, **kw):
    """(out, lse, grads) of the JAX and the port's flash_attn_func for the
    loss sum(out * do) + sum(finite lse * dl), grads w.r.t. q, k, v [, bias]."""
    n = 3 if bias is None else 4
    j_mask = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v, b):
        out, lse = jfa.flash_attn_func(q, k, v, attention_mask=j_mask, attention_bias=b,
                                       return_lse=True, **kw)
        val = jnp.sum(out * jnp.asarray(do))
        return val + jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * jnp.asarray(dl)), (out, lse)

    args = [jnp.asarray(x) for x in (q, k, v)] + [None if bias is None else jnp.asarray(bias)]
    (_, (j_out, j_lse)), jg = jax.value_and_grad(jloss, argnums=tuple(range(n)), has_aux=True)(*args)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v) + (() if bias is None else (bias,))]
    out, lse = flash_attn_func(*leaves[:3], attention_bias=None if bias is None else leaves[3],
                               attention_mask=None if mask is None else torch.from_numpy(mask),
                               return_lse=True, **kw)
    val = (out * torch.from_numpy(do)).sum()
    (val + (torch.where(torch.isfinite(lse), lse, 0.0) * torch.from_numpy(dl)).sum()).backward()
    return ((np.asarray(j_out), np.asarray(j_lse), [np.asarray(g) for g in jg]),
            (out.detach().numpy(), lse.detach().numpy(), [x.grad.numpy() for x in leaves]))


def _assert_close(j, t, tol):
    (j_out, j_lse, j_grads), (t_out, t_lse, t_grads) = j, t
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=tol, err_msg="out")
    assert np.array_equal(np.isneginf(t_lse), np.isneginf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(t_lse[fin], j_lse[fin], rtol=0, atol=tol, err_msg="lse")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), j_grads, t_grads):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)


CASES = {
    # S, D, kw: B1 one block / multi-block (+ B2 backward) / B9; GQA and a
    # ragged padding mask throughout; the last seed is negative.
    "b1-one-block": (100, 64, dict(causal=True, dropout_p=0.2, dropout_seed=11)),
    "b1-multi-block": (300, 64, dict(causal=True, dropout_p=0.1, dropout_seed=2024)),
    "b9": (512, 64, dict(causal=True, dropout_p=0.3, dropout_seed=-7)),
    "noncausal-softcap": (80, 128, dict(causal=False, softcap=5.0, dropout_p=0.5,
                                        dropout_seed=3)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attn_func_dropout_matches_jax(name):
    S, D, kw = CASES[name]
    _, q, k, v, do, dl = _data(S, seed=S + D, D=D)
    mask = np.arange(S)[None] < np.array([S, (2 * S) // 3])[:, None]
    j, t = _both(q, k, v, do, dl, mask=mask, **kw)
    _assert_close(j, t, TOL)
    # The mask really acts: the output differs from the no-dropout one.
    t0 = flash_attn_func(*(torch.from_numpy(x) for x in (q, k, v)),
                         attention_mask=torch.from_numpy(mask), causal=kw["causal"],
                         softcap=kw.get("softcap", 0.0))
    assert np.abs(t[0] - t0.numpy()).max() > 1e-2


def test_bias_and_dbias_with_dropout_match_jax():
    """A per-head bias with dropout: JAX's two-pass backward (B3) and its
    dbias kernel (B4) regenerate the mask; dbias is ds_pre with the dropped
    dp."""
    rng, q, k, v, do, dl = _data(96, seed=5)
    bias = rng.normal(0, 1.0, (1, 4, 96, 96)).astype(np.float32)
    j, t = _both(q, k, v, do, dl, bias=bias, causal=True, dropout_p=0.25, dropout_seed=99)
    assert t[2][3].shape == bias.shape
    _assert_close(j, t, TOL)


def test_b12_causal_strip_with_dropout_matches_plain_backward():
    """The TPU's whole-strip causal backward (B12) with dropout, called
    directly at its smallest shape on o / lse from the port's plain forward
    with the same seed, against the port's `flash_attn_backward`."""
    B, Hq, Hkv, S, D = 1, 2, 1, 1024, 128
    seed, p = 31337, 0.15
    rng = np.random.RandomState(6)
    q, do = (rng.normal(0, s, (B, Hq, S, D)).astype(np.float32) for s in (0.5, 1.0))
    k, v = (rng.normal(0, 0.5, (B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    lens = np.array([[S, S]], np.int32)
    kw = dict(causal=True, softmax_scale=D ** -0.5, dropout_p=p, dropout_seed=seed)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = flash_fwd.flash_attn_forward(*t[:3], torch.from_numpy(lens), **kw)
    tg = flash_bwd.flash_attn_backward(*t, o, lse, torch.from_numpy(lens), **kw)
    jg = jbwd.flash_attn_backward_causal_strip(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do),
        jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()[..., None]), jnp.asarray(lens),
        jnp.array([[0, 0, seed, 0]], jnp.int32), softmax_scale=D ** -0.5, dropout_p=p, sub=512)
    for name, a, b in zip(("dq", "dk", "dv"), jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL, err_msg=name)


def test_forward_mask_is_the_rng_mask():
    """q = 0 makes p uniform over the Sk keys, and v = I reads the mask:
    o[b, i, h, j] = keep[b, h, i, j] / (Sk (1 - p)), with keep from
    `dropout_keep_mask_reference` (the kernels' probe, on the plain twin)."""
    B, S, H, p, seed = 2, 64, 2, 0.3, 77
    q = torch.zeros(B, S, H, S)
    v = torch.eye(S).expand(B, H, S, S).transpose(1, 2).contiguous()
    out = flash_attn_func(q, torch.randn(B, S, H, S), v, dropout_p=p, dropout_seed=seed)
    keep = trng.dropout_keep_mask_reference(seed, p, B, H, S, S)
    want = keep.float().transpose(1, 2) / (S * (1 - p))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_dropout_rng_contract():
    """The same generator state gives the same output, another state
    another, with no seed; the drawn seed is a host int (the generator is a
    CPU one); p = 0 needs no seed."""
    _, q, k, v, _, _ = _data(40, seed=8)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    run = lambda g: flash_attn_func(q, k, v, causal=True, dropout_p=0.3, dropout_rng=g)  # noqa: E731
    a = run(torch.Generator().manual_seed(1))
    a2 = run(torch.Generator().manual_seed(1))
    b = run(torch.Generator().manual_seed(2))
    assert torch.equal(a, a2) and not torch.allclose(a, b)
    g = torch.Generator().manual_seed(1)
    first, second = run(g), run(g)
    assert torch.equal(first, a) and not torch.equal(second, a)
    assert torch.equal(flash_attn_func(q, k, v, causal=True),
                       flash_attn_func(q, k, v, causal=True, dropout_p=0.0))
    with pytest.raises(ValueError, match="int32"):
        flash_attn_func(q, k, v, dropout_p=0.1, dropout_seed=2**31)


# ------------------------- varlen and block-sparse --------------------------

def _packed_both(jfn, tfn, q, k, v, do, dl):
    (out, lse), vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp((jnp.asarray(do), jnp.asarray(dl)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    t_out, t_lse = tfn(*leaves)
    loss = (t_out * torch.from_numpy(do)).sum()
    (loss + (torch.where(torch.isfinite(t_lse), t_lse, 0.0) * torch.from_numpy(dl)).sum()).backward()
    for what, a, b, tol in (("o", t_out.detach().numpy(), np.asarray(out), VARLEN_OUT_TOL),
                            ("lse", t_lse.detach().numpy(), np.asarray(lse), VARLEN_OUT_TOL),
                            *((n, x.grad.numpy(), np.asarray(g), VARLEN_GRAD_TOL)
                              for n, x, g in zip(("dq", "dk", "dv"), leaves, jg))):
        assert a.shape == b.shape and np.array_equal(np.isinf(a), np.isinf(b)), what
        fin = np.isfinite(b)
        assert np.abs(a[fin] - b[fin]).max() <= tol, (what, np.abs(a[fin] - b[fin]).max())
    return t_out.detach()


def test_varlen_dropout_matches_jax():
    lens, (bq, bkv), Hq, Hkv, D = (300, 1, 129), (128, 128), 4, 2, 64
    starts = [0, 384, 512]
    T = 768
    cu = starts + [T]
    rng = np.random.RandomState(21)
    q, do = (rng.normal(0, s, (1, T, Hq, D)).astype(np.float32) for s in (0.5, 0.5))
    k, v = (rng.normal(0, 0.5, (1, T, Hkv, D)).astype(np.float32) for _ in range(2))
    dl = rng.normal(0, 1.0, (1, Hq, T)).astype(np.float32)
    kw = dict(seqlens=lens, causal=True, block_q=bq, block_kv=bkv, return_lse=True,
              dropout_p=0.2, dropout_seed=-42)
    out = _packed_both(lambda a, b, c: jfa.flash_attn_varlen_func(a, b, c, cu, **kw),
                       lambda a, b, c: varlen.flash_attn_varlen_func(a, b, c, cu, **kw),
                       q, k, v, do, dl)
    kw.update(dropout_p=0.0, dropout_seed=None)
    t0 = varlen.flash_attn_varlen_func(*(torch.from_numpy(x) for x in (q, k, v)), cu, **kw)[0]
    assert (out - t0).abs().max().item() > 1e-2


def test_blocksparse_dropout_matches_jax():
    rng = np.random.RandomState(0)
    mask = rng.rand(4, 4) < 0.6
    mask[:, 0] = True
    np.fill_diagonal(mask, True)
    B, S, Hq, Hkv, D = 2, 512, 4, 2, 64
    q, do = (rng.normal(0, 0.5, (B, S, Hq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    dl = rng.normal(0, 1.0, (B, Hq, S)).astype(np.float32)
    kw = dict(causal=True, block_q=128, block_kv=128, return_lse=True, dropout_p=0.3,
              dropout_seed=5)
    _packed_both(lambda a, b, c: jfa.flash_attn_blocksparse_func(a, b, c, mask, **kw),
                 lambda a, b, c: varlen.flash_attn_blocksparse_func(a, b, c, mask, **kw),
                 q, k, v, do, dl)


@pytest.mark.parametrize("Hkv", [4, 1])
def test_mask_probes_read_the_rng_mask(Hkv):
    """The probes `chip_smoke.py` and the card tests read the kernels' masks
    with, run on the plain twins: each reads back the rng mask bit for bit
    (dense at global offsets with longer real lengths, GQA groups 1 and 4,
    and the packed stream at nonzero packed offsets)."""
    from fa2_triton_tpu_torch.utils import mask_probes

    dense = mask_probes.dense_probes(2, 4, Hkv, 64, 0.3, -9, device="cpu", dtype=torch.float32,
                                     q_off=5, kv_off=7, rows=40, seqlen_q_real=100,
                                     seqlen_k_real=200)
    packed = mask_probes.packed_probes(4, Hkv, 64, 0.3, 12, device="cpu", dtype=torch.float32,
                                       block=64)
    assert set(dense) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_dbias"}
    assert set(packed) == {"varlen_fwd", "varlen_dq", "varlen_dkdv"}
    for name, (got, want, resid) in {**dense, **packed}.items():
        assert got.shape == want.shape and torch.equal(got, want), name
        assert 0.6 < want.float().mean().item() < 0.8, name
        assert resid < 1e-4, (name, resid)
