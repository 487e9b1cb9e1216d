"""The causal backward schedules and the bias gradient at head dims 384 and
512 against the JAX package's, on the CPU: the port's plain twins (which
walk the 16-bit kernels' partitions in their 32-row tiles past D 256) and
JAX's Pallas kernels in interpret mode, on the same numpy-seeded inputs.

* B13 tri-square at B 1, H 2 / 2, S 256 (tests/test_large_head_dim.py's
  shape, where JAX's dispatch takes it), with a dlse cotangent; once with
  dropout p 0.1 (the counter-hash mask is bitwise on both sides);
* B13 diag: leaves of 128 on S 256, k prescaled and the global delta;
* B14 work list at S 1024, sub 256, block_kv 512 (two strips: the strips'
  dq partials);
* `flash_attn_func`'s vjp at D 512, S 256, causal, where both dispatches
  take the tri-square;
* B4: `flash_attn_func` with a trainable [1, H, S, S] bias at S 128,
  causal at D 384 and not at D 512, its dbias.

fp32 everywhere; dq, dk, dv and dbias within 1e-4 and outputs within 2e-5,
JAX's own bounds past D 256 (tests/test_large_head_dim.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.ops import flash_bwd as jb

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

OUT_TOL, GRAD_TOL = 2e-5, 1e-4
SEED = 11        # the dropout seed


def _case(D, S, seed, dropout_p=0.0):
    """numpy inputs (q, k, v, do BHSD, dlse) and the port's plain forward
    (o, lse) of them, causal, B 1, 2 / 2 heads, which both sides take."""
    rng = np.random.RandomState(seed)
    x = [rng.normal(0, 0.5, (1, 2, S, D)).astype(np.float32) for _ in range(4)]
    dlse = rng.normal(0, 0.1, (1, 2, S)).astype(np.float32)
    lens = torch.tensor([[S, S]], dtype=torch.int32)
    o, lse = flash_fwd.flash_attn_forward_plain(
        *(torch.from_numpy(a) for a in x[:3]), lens, causal=True, softmax_scale=D ** -0.5,
        dropout_p=dropout_p, dropout_seed=SEED)
    return x, dlse, o.numpy(), lse.numpy(), lens


def _jax_args(x, o, lse, S):
    lens = jnp.array([[S, S]], jnp.int32)
    scal = jnp.array([[0, 0, SEED, 0]], jnp.int32)
    return [jnp.asarray(a) for a in x] + [jnp.asarray(o), jnp.asarray(lse)[..., None], lens, scal]


def _torch_args(x, o, lse, lens):
    return [torch.from_numpy(a) for a in x] + [torch.from_numpy(o), torch.from_numpy(lse), lens]


def _close(got, want, names=("dq", "dk", "dv"), tol=GRAD_TOL):
    for name, t, j in zip(names, got, want):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("D,dropout_p", [(384, 0.0), (512, 0.0), (384, 0.1)])
def test_tri_square_matches_jax(D, dropout_p):
    S = 256
    x, dlse, o, lse, lens = _case(D, S, D, dropout_p)
    kw = dict(softmax_scale=D ** -0.5, dropout_p=dropout_p)
    *jx, jlens, scal = _jax_args(x, o, lse, S)
    want = jb.flash_attn_backward_tri_square(*jx, jlens, scal, sub=128,
                                             dlse=jnp.asarray(dlse)[..., None], **kw)
    got = flash_bwd.flash_attn_backward_tri_square(*_torch_args(x, o, lse, lens),
                                                   dlse=torch.from_numpy(dlse),
                                                   dropout_seed=SEED, **kw)
    _close(got, want)
    assert flash_bwd.backward_route(S, S, D, 4, causal=True, static_skip=True) == "tri_square"


@pytest.mark.parametrize("D", [384, 512])
def test_causal_diag_matches_jax(D):
    """Leaves of 128 on S 256 from the prescaled k and the global delta (the
    split's first launch), full-size outputs."""
    S, scale = 256, D ** -0.5
    x, dlse, o, lse, lens = _case(D, S, D + 1)
    q, k, v, do = x
    k_p = (k * np.float32(scale * jb.LOG2E)).astype(np.float32)
    delta = (o * do).sum(-1) - dlse * np.float32(jb.LOG2E)
    want = jb.flash_attn_backward_causal_diag(
        jnp.asarray(q), jnp.asarray(k_p), jnp.asarray(v), jnp.asarray(do),
        jnp.asarray(lse)[..., None], jnp.asarray(delta)[..., None], jnp.array([[S, S]], jnp.int32),
        jnp.array([[0, 0, SEED, 0]], jnp.int32), T=128, sub=128, softmax_scale=scale)
    got = flash_bwd.flash_attn_backward_causal_diag(
        *(torch.from_numpy(a) for a in (q, k_p, v, do, lse, delta)), lens, T=128,
        softmax_scale=scale)
    _close(got, want)


@pytest.mark.parametrize("D", [384, 512])
def test_worklist_matches_jax(D):
    """Two strips of 512 columns in steps of 256 (tests/test_worklist_bwd.py's
    multi-strip case at B 1), the strips' fp32 dq partials added in strip
    order."""
    S = 1024
    x, dlse, o, lse, lens = _case(D, S, D + 2)
    kw = dict(causal=True, softmax_scale=D ** -0.5, sub=256, block_kv=512)
    *jx, jlens, scal = _jax_args(x, o, lse, S)
    want = jb.flash_attn_backward_fused_wl(*jx, jlens, scal, dlse=jnp.asarray(dlse)[..., None],
                                           **kw)
    got = flash_bwd.flash_attn_backward_fused_wl(*_torch_args(x, o, lse, lens),
                                                 dlse=torch.from_numpy(dlse), **kw)
    _close(got, want)


def _func_both(x, kw, bias=None):
    """(out, dq, dk, dv[, dbias]) of JAX's flash_attn_func and the port's,
    BSHD, under the cotangent x[3]."""
    q, k, v, do = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in x)
    args = [q, k, v] + ([bias] if bias is not None else [])

    def jfn(q, k, v, *b):
        return jfa.flash_attn_func(q, k, v, attention_bias=b[0] if b else None, **kw)
    j_out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    j = [j_out] + list(vjp(jnp.asarray(do)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = flash_attn_func(*leaves[:3], attention_bias=leaves[3] if bias is not None else None, **kw)
    out.backward(torch.from_numpy(do))
    return j, [out] + [t.grad for t in leaves]


def test_flash_attn_func_vjp_at_512_matches_jax_through_the_tri_square():
    D, S = 512, 256
    assert flash_bwd.backward_route(S, S, D, 4, causal=True, static_skip=True) == "tri_square"
    x, _, _, _, _ = _case(D, S, D + 3)
    j, t = _func_both(x, dict(causal=True))
    _close(t[:1], j[:1], ("out",), OUT_TOL)
    _close(t[1:], j[1:])


@pytest.mark.parametrize("D,causal", [(384, True), (512, False)])
def test_dbias_matches_jax(D, causal):
    """A trainable [1, H, S, S] bias at S 128: out, dq / dk / dv and dbias."""
    S = 128
    x, _, _, _, _ = _case(D, S, D + 4)
    bias = np.random.RandomState(D).normal(0, 0.5, (1, 2, S, S)).astype(np.float32)
    j, t = _func_both(x, dict(causal=causal), bias)
    _close(t[:1], j[:1], ("out",), OUT_TOL)
    _close(t[1:], j[1:], ("dq", "dk", "dv", "dbias"))
