"""The port's `FlashSelfAttention` (`fa2_triton_tpu_torch/layers.py`, plain
attention twins on the CPU) against the linen module of
`fa2_triton_tpu/layers.py` (Pallas kernels in interpret mode) on the same
params, converted with `flash_self_attention_from_flax`, fp32.

Tolerance 1e-5 max abs: both sides project, rotate and attend in fp32 on
the same values; only the summation order differs. Dropout in training
mode is held to the JAX `flash_attn_func` with the same `dropout_seed` on
the same projections (linen derives its seed from a flax rng by threefry,
which torch cannot reproduce, so the generator path is held to the linen
module's contract of `tests/test_layers.py:59-80` instead).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.layers import FlashSelfAttention as LinenFlashSelfAttention
from fa2_triton_tpu.models.llama import apply_rope as j_apply_rope
from fa2_triton_tpu.models.llama import rope_cos_sin as j_rope_cos_sin

torch = pytest.importorskip("torch")
from torch.utils.checkpoint import checkpoint  # noqa: E402

from fa2_triton_tpu_torch import FlashSelfAttention  # noqa: E402
from fa2_triton_tpu_torch.layers import flash_self_attention_from_flax  # noqa: E402

TOL = 1e-5
B, S, F = 2, 64, 128


def _make(seed=0, **kw):
    linen = LinenFlashSelfAttention(num_heads=4, **kw)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (B, S, F), jnp.float32)) * 0.5
    params = linen.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(seed)
    # flax zero-initialises biases; random ones make the bias path count.
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.1, a.shape).astype(np.float32)
                         if path[-1].key == "bias" else np.asarray(a)), params)
    layer = flash_self_attention_from_flax(params, F, num_heads=4, device="cpu", **kw)
    return linen, params, layer, x


LINEN_CASES = {   # name: (module fields, with a padding mask)
    "mha": (dict(), False),
    "gqa-causal-rope-masked": (dict(num_kv_heads=2, causal=True, use_rope=True, rope_theta=1e4),
                               True),
    "mqa-bias-window-softcap-masked": (dict(num_kv_heads=1, use_bias=True, window_size=(8, 8),
                                            softcap=5.0), True),
}


@pytest.mark.parametrize("name", sorted(LINEN_CASES))
def test_eval_mode_matches_linen(name):
    kw, masked = LINEN_CASES[name]
    linen, params, layer, x = _make(**kw)
    mask = np.arange(S)[None] < np.array([S, 40])[:, None] if masked else None
    want = linen.apply(params, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    layer.eval()
    got = layer(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_parameter_names_and_shapes_are_flax():
    _, params, layer, _ = _make(num_kv_heads=2, use_bias=True)
    p = params["params"]
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == {
        f"{n}.{leaf}": tuple(p[n][leaf].shape) for n in p for leaf in p[n]}
    with pytest.raises(ValueError, match="do not match"):
        flash_self_attention_from_flax(params, F, num_heads=4, num_kv_heads=2, device="cpu")


def test_training_mode_dropout_matches_jax_flash_attn_func():
    """Training mode with a dropout_seed: the JAX flash_attn_func with the
    same seed on the same projections (q / k / v from the linen params,
    RoPE, the o projection)."""
    kw = dict(num_kv_heads=2, causal=True, use_rope=True, dropout_p=0.2)
    _, params, layer, x = _make(seed=3, **kw)
    p = params["params"]
    xj = jnp.asarray(x)
    q, k, v = (jnp.einsum("bsf,fhd->bshd", xj, p[n]["kernel"]) for n in ("q_proj", "k_proj", "v_proj"))
    cos, sin = j_rope_cos_sin(jnp.arange(S), 32, 10000.0)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q, k = j_apply_rope(q, cos, sin), j_apply_rope(k, cos, sin)
    att = jfa.flash_attn_func(q, k, v, causal=True, dropout_p=0.2, dropout_seed=-1234)
    want = jnp.einsum("bsg,gf->bsf", att.reshape(B, S, 128), p["o_proj"]["kernel"])
    layer.train()
    got = layer(torch.from_numpy(x), dropout_seed=-1234)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    layer.eval()
    assert np.abs(layer(torch.from_numpy(x)).detach().numpy() - np.asarray(want)).max() > 1e-3


def test_dropout_rng_contract():
    """The linen contract (tests/test_layers.py:59-80): eval needs no rng and
    is deterministic; training mode with the same generator state gives the
    same output, another state another, both unlike eval; no rng raises."""
    _, _, layer, x = _make(dropout_p=0.5)
    xt = torch.from_numpy(x)
    layer.eval()
    det = layer(xt)
    assert torch.equal(det, layer(xt))
    layer.train()
    a = layer(xt, dropout_rng=torch.Generator().manual_seed(3))
    a2 = layer(xt, dropout_rng=torch.Generator().manual_seed(3))
    b = layer(xt, dropout_rng=torch.Generator().manual_seed(4))
    assert torch.equal(a, a2)
    assert not torch.allclose(a, b) and not torch.allclose(a, det)
    with pytest.raises(ValueError, match="dropout_seed or a dropout_rng"):
        layer(xt)
    layer.dropout_rng = torch.Generator().manual_seed(3)   # the constructor's generator
    assert torch.equal(layer(xt), a)


def _grads(layer, x, remat):
    x = x.clone().requires_grad_()
    out = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    (out.float() ** 2).sum().backward()
    grads = [x.grad] + [p.grad.clone() for p in layer.parameters()]
    layer.zero_grad(set_to_none=True)
    return grads


def test_remat_gives_the_same_gradients():
    """Under torch.utils.checkpoint the forward runs again in the backward.
    With torch.default_generator as the dropout_rng, checkpoint restores its
    state, the recompute draws the same seed, and the gradients equal those
    of the run without checkpoint bit for bit. A private generator, which
    checkpoint does not restore, gives other gradients: the check is
    sensitive to a redrawn mask."""
    _, _, layer, x = _make(num_kv_heads=2, causal=True, use_rope=True, dropout_p=0.3)
    layer.train()
    layer.dropout_rng = torch.default_generator
    xt = torch.from_numpy(x)
    runs = []
    for remat in (False, True):
        torch.manual_seed(7)
        runs.append(_grads(layer, xt, remat))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    layer.dropout_rng = torch.Generator().manual_seed(7)
    plain = _grads(layer, xt, False)
    layer.dropout_rng = torch.Generator().manual_seed(7)
    redrawn = _grads(layer, xt, True)
    assert not torch.allclose(plain[0], redrawn[0])
