"""The port's `flash_attn_func` (plain path on the CPU) against the JAX
`flash_attn_func` (Pallas kernels in interpret mode), padded + causal as the
serving prefill calls it, and its kernel-less entry points.

Sequence lengths pick the JAX schedules the slice reaches: 100 -> one B1
block (`_fwd_kernel`), 300 -> B1 multi-block (`flash_attn_func` pads 300 to
384, which the tri-square kernel refuses), 512 and 900 -> B9
(`_fwd_tri_square_kernel`). Tolerance 1e-5 max abs on o and on the base-2
lse: both sides compute in fp32, so only the summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

TOL = 1e-5


def _inputs(S, D, seed):
    rng = np.random.RandomState(seed)
    B, Hq, Hkv = 2, 4, 2
    q = rng.normal(0, 0.5, (B, S, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, S, Hkv, D)).astype(np.float32)
    mask = np.arange(S)[None] < np.array([S, (2 * S) // 3])[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("S,D", [(100, 64), (100, 128), (300, 128), (512, 64), (900, 128)])
def test_padded_causal_matches_jax(S, D):
    q, k, v, mask = _inputs(S, D, seed=S + D)
    j_out, j_lse = jfa.flash_attn_func(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), attention_mask=jnp.asarray(mask),
        causal=True, return_lse=True)
    t_out, t_lse = flash_attn_func(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attention_mask=torch.from_numpy(mask), causal=True, return_lse=True)
    assert t_out.shape == q.shape and t_lse.shape == (2, 4, S)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=TOL)
    j_lse = np.asarray(j_lse)
    t_lse = t_lse.numpy()
    assert np.array_equal(np.isneginf(t_lse), np.isneginf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(t_lse[fin], j_lse[fin], rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", [
    dict(causal=False), dict(causal=True, window_size=(16, 0)),
    dict(causal=False, window_size=(8, 8)), dict(causal=True, softcap=5.0),
    dict(causal=True, softmax_scale=0.2),
])
def test_knobs_match_jax(kw):
    q, k, v, _ = _inputs(80, 64, seed=7)
    j_out = jfa.flash_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    t_out = flash_attn_func(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=TOL)


def test_rectangular_causal_matches_jax():
    """Sq < Sk without a mask: the causal diagonal is bottom-right aligned."""
    rng = np.random.RandomState(3)
    q = rng.normal(0, 0.5, (1, 24, 4, 64)).astype(np.float32)
    k = rng.normal(0, 0.5, (1, 70, 2, 64)).astype(np.float32)
    v = rng.normal(0, 0.5, (1, 70, 2, 64)).astype(np.float32)
    j_out = jfa.flash_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    t_out = flash_attn_func(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=TOL)


def test_forward_offsets_match_reference():
    """Global q/kv offsets: a query chunk at rows [off, off + C) of a longer
    sequence equals the matching rows of the full causal forward."""
    rng = np.random.RandomState(4)
    S, C, off = 50, 12, 30
    q = torch.from_numpy(rng.normal(0, 0.5, (1, 2, S, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 0.5, (1, 2, S, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 0.5, (1, 2, S, 64)).astype(np.float32))
    full_lens = torch.tensor([[S, S]], dtype=torch.int32)
    o_full, lse_full = flash_fwd.flash_attn_forward(q, k, v, full_lens, causal=True, softmax_scale=0.125)
    chunk_lens = torch.tensor([[off + C, off + C]], dtype=torch.int32)
    o_c, lse_c = flash_fwd.flash_attn_forward(q[:, :, off:off + C], k, v, chunk_lens, off, 0,
                                              causal=True, softmax_scale=0.125)
    torch.testing.assert_close(o_c, o_full[:, :, off:off + C], rtol=0, atol=TOL)
    torch.testing.assert_close(lse_c, lse_full[:, :, off:off + C], rtol=0, atol=TOL)


def test_not_ported_features_raise():
    """Dropout without a seed (or with both a seed and a generator, or with
    p outside [0, 1)) raises the seed contract's ValueError; a bias is
    ported, and one that does not broadcast raises."""
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        flash_attn_func(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        flash_attn_func(q, q, q, dropout_p=0.1, dropout_seed=0, dropout_rng=torch.Generator())
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        flash_attn_func(q, q, q, dropout_p=1.0, dropout_seed=0)
    with pytest.raises(ValueError, match="broadcast"):
        flash_attn_func(q, q, q, attention_bias=torch.zeros(1, 3, 8, 8))


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel or raises: a meta
    tensor (no data) must raise, not quietly run the plain version."""
    q = torch.empty(1, 2, 8, 64, device="meta")
    lens = torch.empty(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_fwd.flash_attn_forward(q, q, q, lens, causal=True, softmax_scale=0.125)


def test_plain_path_is_differentiable_on_cpu():
    q = torch.randn(1, 16, 2, 64, requires_grad=True)
    out = flash_attn_func(q, q.detach(), q.detach(), causal=True)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("D", [32, 96, 160])
def test_head_dims_off_the_kernel_widths_match_jax(D):
    """A head dim the kernels are not built for is zero-padded to the next
    of 64 / 128 / 256 with the scale of the true D (exact): output and
    gradients against the JAX flash_attn_func, which pads to 128 lanes."""
    import jax

    q, k, v, mask = _inputs(70, D, seed=D)
    do = np.random.RandomState(D + 1).normal(0, 1.0, q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jfa.flash_attn_func(q, k, v, attention_mask=jnp.asarray(mask), causal=True)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, j_out), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attn_func(*leaves, attention_mask=torch.from_numpy(mask), causal=True)
    (out * torch.from_numpy(do)).sum().backward()
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=TOL)
    for name, x, g in zip(("dq", "dk", "dv"), leaves, j_grads):
        assert x.grad.shape == x.shape
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=0, atol=TOL, err_msg=name)
