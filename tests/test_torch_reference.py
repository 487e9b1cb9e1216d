"""The PyTorch port's attention oracle against the JAX oracle: same
numpy-seeded inputs, fp32, max abs <= 1e-5 (the fp32 summation-order bound
for scores of this size)."""
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.ops import reference as jref

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import reference as tref  # noqa: E402

TOL = 1e-5

CASES = {
    "plain": dict(),
    "causal": dict(causal=True),
    "causal_rect": dict(causal=True, sk=40),
    "window": dict(window_size=(5, 3)),
    "window_left_only": dict(window_size=(6, -1)),
    "window_right_only": dict(window_size=(-1, 4)),
    "causal_window": dict(causal=True, window_size=(7, -1)),
    "softcap": dict(softcap=2.0, causal=True),
    "masks": dict(masks=True, causal=True),
    "masks_window": dict(masks=True, window_size=(4, 2)),
    "bias": dict(bias=True),
    "bias_masks": dict(bias=True, masks=True),
    "dropout_mask": dict(dropout=True),
    "scale": dict(softmax_scale=0.3, causal=True),
    "lowp_reorder": dict(upcast=False, reorder_ops=True, causal=True),
    "mha": dict(hkv=4, causal=True),
}


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    B, Sq, Hq, D = 2, 33, 4, 16
    Sk = case.get("sk", Sq)
    Hkv = case.get("hkv", 2)
    q = rng.normal(0, 0.5, (B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, Sk, Hkv, D)).astype(np.float32)
    kw = {}
    if case.get("masks"):
        lens = np.array([Sq, 21])
        kw["query_padding_mask"] = np.arange(Sq)[None] < lens[:, None]
        kw["key_padding_mask"] = np.arange(Sk)[None] < lens[:, None]
    if case.get("bias"):
        kw["attn_bias"] = rng.normal(0, 1.0, (1, Hq, Sq, Sk)).astype(np.float32)
    if case.get("dropout"):
        kw["dropout_p"] = 0.25
        kw["dropout_mask"] = rng.uniform(size=(B, Hq, Sq, Sk)) >= 0.25
    for key in ("causal", "window_size", "softcap", "softmax_scale", "upcast", "reorder_ops"):
        if key in case:
            kw[key] = case[key]
    return q, k, v, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax(name):
    q, k, v, kw = _inputs(CASES[name])
    j_kw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val) for key, val in kw.items()}
    t_kw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray) else val) for key, val in kw.items()}
    j_out, j_lse = jref.flash_attn_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True, **j_kw)
    t_out, t_lse = tref.flash_attn_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), return_lse=True, **t_kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=TOL)
    j_lse = np.asarray(j_lse)
    t_lse = t_lse.numpy()
    assert np.array_equal(np.isinf(t_lse), np.isinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(t_lse[fin], j_lse[fin], rtol=0, atol=TOL)


@pytest.mark.parametrize("window", [(-1, -1), (3, 0), (-1, 2), (4, -1), (2, 5)])
def test_construct_local_mask_matches_jax(window):
    lens = np.array([12, 7])
    qpm = np.arange(12)[None] < lens[:, None]
    kpm = np.arange(15)[None] < np.array([15, 9])[:, None]
    j = np.asarray(jref.construct_local_mask(12, 15, window, jnp.asarray(qpm), jnp.asarray(kpm)))
    t = tref.construct_local_mask(12, 15, window, torch.from_numpy(qpm), torch.from_numpy(kpm)).numpy()
    j, t = np.broadcast_arrays(j, t)
    assert np.array_equal(t, j)
