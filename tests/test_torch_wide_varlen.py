"""Packed varlen and block-sparse attention of the port at head dims 384
and 512 against the JAX package's, on the CPU: the port's plain twins
(through `_VarlenCore`, as `flash_attn_varlen_func` and
`flash_attn_blocksparse_func` reach them) and JAX's Pallas B7 / B8 kernels
in interpret mode, on the same numpy-seeded fp32 inputs.

* `flash_attn_varlen_func` at D 384 (causal, GQA 2), at D 512 (not causal,
  GQA 1, block_kv 256 over block_q 128) and at D 320, which both sides pad
  to 384 (causal, GQA 2, dropout p 0.1 from the same seed: the counter-hash
  mask is bitwise on both sides);
* `flash_attn_blocksparse_func` at D 512, causal, GQA 2, with a q block that
  keeps no kv block and a kv block that no q block keeps.

Each case is one stream of T 512 in blocks of 128 (256 for one kv block
size), and each side computes it once for the module.

Tolerance: outputs (o, base-2 lse) 2e-5 and gradients 1e-4 max abs, fp32:
JAX's own bounds past D 256 (tests/test_large_head_dim.py:35-38), whose
longer sums over D 512 take the gradient bound from 5e-5
(tests/test_torch_varlen.py) to 1e-4. Dead positions are exactly 0 (lse
-inf) on the port's side.

The last tests stand in for the C entry point (no build): the wrappers
hand the kernels D 384 / 512 and the same launch tables as at D 128.
"""
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import varlen  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import kernel_head_dim  # noqa: E402

OUT_TOL, GRAD_TOL = 2e-5, 1e-4
SEED = 23        # the dropout seed
LENS, STARTS, T = (200, 129), (0, 256), 512
BS_MASK = np.array([[1, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 1, 1]], bool)

# name: (entry point, D, causal, Hq, Hkv, (block_q, block_kv), dropout_p)
CASES = {
    "varlen D 384 causal GQA 2": ("varlen", 384, True, 2, 1, (128, 128), 0.0),
    "varlen D 512 GQA 1": ("varlen", 512, False, 2, 2, (128, 256), 0.0),
    "varlen D 320 causal GQA 2 dropout": ("varlen", 320, True, 2, 1, (128, 128), 0.1),
    "blocksparse D 512 causal GQA 2": ("blocksparse", 512, True, 2, 1, (128, 128), 0.0),
}


def _inputs(name):
    """q, k, v, do (BSHD, B 1 x T for the packed stream) and the lse
    cotangent [1, Hq, T]; the gaps between segments hold nonzero values,
    which must reach no live output."""
    _, D, _, Hq, Hkv, _, _ = CASES[name]
    rng = np.random.RandomState(D + Hq + 3 * Hkv + len(name))
    q, k, v, do = (rng.normal(0, 0.5, (1, T, h, D)).astype(np.float32)
                   for h in (Hq, Hkv, Hkv, Hq))
    dl = rng.normal(0, 1.0, (1, Hq, T)).astype(np.float32)
    return q, k, v, do, dl


def _call(name, mod):
    """The entry point of case `name` in package module `mod` (JAX's or the
    port's), as a function of (q, k, v) -> (out, lse)."""
    entry, _, causal, _, _, (bq, bkv), p = CASES[name]
    kw = dict(causal=causal, block_q=bq, block_kv=bkv, return_lse=True)
    if p:
        kw.update(dropout_p=p, dropout_seed=SEED)
    if entry == "varlen":
        cu = list(STARTS) + [T]
        return lambda a, b, c: mod.flash_attn_varlen_func(a, b, c, cu, seqlens=LENS, **kw)
    return lambda a, b, c: mod.flash_attn_blocksparse_func(a, b, c, BS_MASK, **kw)


@functools.lru_cache(maxsize=None)
def _jax(name):
    q, k, v, do, dl = _inputs(name)
    (out, lse), vjp = jax.vjp(_call(name, jfa), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp((jnp.asarray(do), jnp.asarray(dl)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _torch(name):
    """out, lse and (dq, dk, dv) of sum(out * do) + sum(finite lse * dl)."""
    q, k, v, do, dl = _inputs(name)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = _call(name, varlen)(*leaves)
    loss = (out * torch.from_numpy(do)).sum()
    loss = loss + (torch.where(torch.isfinite(lse), lse, 0.0) * torch.from_numpy(dl)).sum()
    loss.backward()
    return out.detach().numpy(), lse.detach().numpy(), [x.grad.numpy() for x in leaves]


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    fin = np.isfinite(b)
    err = np.abs(a[fin] - b[fin]).max() if fin.any() else 0.0
    assert err <= tol, (what, err)


def _dead_rows(name):
    """[T] bool: packed positions no live row reads or writes (the gaps of
    the varlen stream; none for the block-sparse batch, whose filtered rows
    are live rows that keep nothing)."""
    dead = np.ones(T, bool)
    if CASES[name][0] == "blocksparse":
        return ~dead
    for s0, n in zip(STARTS, LENS):
        dead[s0:s0 + n] = False
    return dead


@pytest.mark.parametrize("name", list(CASES))
def test_wide_packed_forward_matches_jax(name):
    j_out, j_lse, _ = _jax(name)
    t_out, t_lse, _ = _torch(name)
    assert t_out.shape[-1] == CASES[name][1]
    _close(t_out, j_out, OUT_TOL, "o")
    _close(t_lse, j_lse, OUT_TOL, "lse")


@pytest.mark.parametrize("name", list(CASES))
def test_wide_packed_gradients_match_jax(name):
    _, _, j_grads = _jax(name)
    _, _, t_grads = _torch(name)
    for what, tg, jg in zip(("dq", "dk", "dv"), t_grads, j_grads):
        _close(tg, jg, GRAD_TOL, what)


@pytest.mark.parametrize("name", list(CASES))
def test_wide_packed_dead_positions_are_exactly_zero(name):
    """Gaps of the packed stream: o = 0, lse = -inf and zero gradients; in
    the block-sparse case the rows of the filtered q block keep nothing
    (o = 0, lse = -inf, dq = 0) and the kv block no q block keeps gets dk =
    dv = 0."""
    t_out, t_lse, (dq, dk, dv) = _torch(name)
    dead = _dead_rows(name)
    if CASES[name][0] == "blocksparse":
        rows, cols = slice(256, 384), slice(128, 256)      # q block 2, kv block 1
        assert not t_out[0, rows].any() and np.all(t_lse[0, :, rows] == -np.inf)
        assert not dq[0, rows].any() and not dk[0, cols].any() and not dv[0, cols].any()
        return
    assert not t_out[0, dead].any() and np.all(t_lse[0][:, dead] == -np.inf)
    for g in (dq, dk, dv):
        assert not g[0, dead].any()


# ------------------------ the C entry point stood in -----------------------

def _read(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_int * n).from_address(ptr)).copy()


def _launches(monkeypatch, entry, D):
    """(which, D, (work, rowptr, order)) of every launch of `entry`'s fwd +
    bwd at head dim D, bf16, through the public entry point with the C
    entry point stood in (the kernels' path, on CPU tensors)."""
    _, _, causal, Hq, Hkv, (bq, bkv), p = CASES[entry]
    seen = []

    def fake(which, *args):
        n_blocks = T // (bkv if which == 2 else bq)
        rowptr = _read(args[16], n_blocks + 1)
        tables = (_read(args[15], 8 * int(rowptr[-1])).reshape(-1, 8), rowptr,
                  _read(args[17], T // varlen.TILE_ROWS))
        seen.append((which, args[4], tables))
        return 0

    monkeypatch.setattr(varlen, "_entry", lambda: fake)
    monkeypatch.setattr(varlen._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(varlen, "_uses_kernels", lambda q: True)
    monkeypatch.setattr(varlen, "LAUNCHES", dict.fromkeys(varlen.LAUNCHES, 0))
    x = [torch.zeros(1, T, h, D, dtype=torch.bfloat16).requires_grad_() for h in (Hq, Hkv, Hkv)]
    out, _ = _call(entry, varlen)(*x)
    out.backward(torch.zeros_like(out))
    assert varlen.LAUNCHES == {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}
    return seen


@pytest.mark.parametrize("D", [320, 384, 448, 512])
@pytest.mark.parametrize("entry", ["varlen D 384 causal GQA 2", "blocksparse D 512 causal GQA 2"])
def test_wide_wrappers_hand_the_kernels_the_padded_dim_and_the_d128_tables(monkeypatch, entry,
                                                                            D):
    """Forward (0), dq (1) and dk/dv (2) each get the kernels' head dim
    (320 and 384 -> 384, 448 and 512 -> 512) and, bit for bit, the work
    list, row pointer and tile order they get at D 128: the host tables
    stay in 64-row tiles whatever the head dim (the kernels halve them past
    256)."""
    got = _launches(monkeypatch, entry, D)
    want = _launches(monkeypatch, entry, 128)
    assert [w for w, _, _ in got] == [0, 1, 2]
    assert {d for _, d, _ in got} == {kernel_head_dim(D)} and kernel_head_dim(D) in (384, 512)
    assert {d for _, d, _ in want} == {128}
    for (_, _, g), (_, _, w) in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
