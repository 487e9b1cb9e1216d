"""The port's benchmark baselines (`other_implementations/`) against the
JAX package's `xla_attention` on the same numpy-seeded CPU inputs, fp32:
dense attention (outputs and gradients), SDPA's flash backend and
flex_attention (eager here). Tolerance 1e-5 max abs (2e-5 for
gradients): both sides compute in fp32, only the order of the sums
differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.other_implementations import xla_attention

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.other_implementations import (  # noqa: E402
    dense_attention, flex_attention, sdpa_flash_attention)

TOL, GRAD_TOL = 1e-5, 2e-5


def _inputs(Sq, Sk, Hq, Hkv, D=32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 0.5, (2, s, h, D)).astype(np.float32)
            for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]


CASES = [(48, 48, 4, 4, False), (48, 48, 4, 2, True), (40, 72, 4, 1, True), (72, 40, 2, 2, False)]


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,causal", CASES)
def test_dense_matches_xla_attention(Sq, Sk, Hq, Hkv, causal):
    """Output and q / k / v gradients of a random cotangent."""
    q, k, v = _inputs(Sq, Sk, Hq, Hkv, seed=Sq + Hkv)
    do = np.random.RandomState(1).normal(0, 1, q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = xla_attention(q, k, v, causal=causal, softmax_scale=0.2)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, j_out), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = dense_attention(*leaves, causal=causal, softmax_scale=0.2)
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=TOL)
    for name, x, g in zip(("dq", "dk", "dv"), leaves, j_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=0, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,causal", [c for c in CASES if c[0] == c[1] or not c[4]])
@pytest.mark.parametrize("impl", [sdpa_flash_attention, flex_attention])
def test_library_baselines_match_xla_attention(impl, Sq, Sk, Hq, Hkv, causal):
    q, k, v = _inputs(Sq, Sk, Hq, Hkv, seed=3)
    want = xla_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    with torch.no_grad():
        got = impl(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_flex_aligns_a_rectangular_causal_mask_bottom_right():
    q, k, v = _inputs(40, 72, 4, 2, seed=5)
    want = xla_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    with torch.no_grad():
        got = flex_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_sdpa_flash_refuses_a_rectangular_causal_call():
    q, k, v = (torch.from_numpy(x) for x in _inputs(40, 72, 4, 2))
    with pytest.raises(ValueError, match="top-left"):
        sdpa_flash_attention(q, k, v, causal=True)
