"""The port's `decode_attention` (plain path on the CPU) against the JAX
`decode_attention` (Pallas `_decode_kernel_noquant` in interpret mode): one
query token per slot over a contiguous cache with ragged lengths, including
1. Max abs <= 1e-5: fp32 on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.ops import decode as jdec

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import decode as tdec  # noqa: E402

TOL = 1e-5
KV_LENS = np.array([1, 5, 130, 256], np.int32)


def _inputs(seed, Hq=4, Hkv=2, D=128, S_max=256):
    rng = np.random.RandomState(seed)
    B = len(KV_LENS)
    q = rng.normal(0, 0.5, (B, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, Hkv, S_max, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, Hkv, S_max, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kw", [
    dict(), dict(window_left=7), dict(softcap=3.0), dict(window_left=100, softcap=2.0),
    dict(softmax_scale=0.05),
])
def test_decode_matches_jax(kw):
    q, k, v = _inputs(seed=len(kw))
    j = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(KV_LENS), **kw)
    t = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(KV_LENS), **kw)
    assert t.shape == q.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


def test_decode_mqa_matches_jax():
    q, k, v = _inputs(seed=11, Hq=4, Hkv=1)
    j = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(KV_LENS))
    t = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(KV_LENS))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


def test_decode_ignores_garbage_past_kv_len():
    """Rows at or past kv_len never reach the output, even NaN ones."""
    q, k, v = _inputs(seed=12)
    base = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(KV_LENS))
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(KV_LENS):
        k2[b, :, n:] = np.nan
        v2[b, :, n:] = np.nan
    out = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2),
                                torch.from_numpy(KV_LENS))
    torch.testing.assert_close(out, base, rtol=0, atol=0)


def test_quantized_cache_raises():
    q, k, v = _inputs(seed=13)
    scale = torch.ones(len(KV_LENS), 2, 1, 256)
    with pytest.raises(NotImplementedError, match="quantized"):
        tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(KV_LENS), scale, scale)
