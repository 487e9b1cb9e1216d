"""The port's LLaMA model against the JAX model on the same weights: a JAX
`init_params` tree converted with `llama_from_jax_params`, then `forward`,
padded `prefill_forward` and a few `decode_step`s on both sides. fp32, 2
layers, narrow widths. Logits within 1e-4 max abs: fp32 everywhere, so only
summation order and transcendental rounding differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.runtime import kv_cache as jkv

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.runtime import kv_cache as tkv  # noqa: E402

TOL = 1e-4
J_CFG = jl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=256, rope_theta=10000.0, dtype=jnp.float32)
T_CFG = tl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=256, rope_theta=10000.0, dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tm = llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")
    return jp, tm


def test_conversion_is_a_copy(models):
    jp, tm = models
    np.testing.assert_array_equal(tm.layers[1].wq.detach().numpy(), np.asarray(jp["layers"][1]["wq"]))
    np.testing.assert_array_equal(tm.lm_head.detach().numpy(), np.asarray(jp["lm_head"]))
    assert tm.layers[0].attn_norm.dtype == torch.float32


def test_forward_matches_jax(models):
    jp, tm = models
    tokens = np.random.RandomState(0).randint(0, 128, size=(2, 37))
    j = np.asarray(jl.forward(jp, jnp.asarray(tokens, jnp.int32), J_CFG))
    with torch.no_grad():
        t = tl.forward(tm, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


def test_prefill_and_decode_match_jax(models):
    """Padded prefill (bucket 64, true lengths 29 and 64), cache fill, then
    three decode steps with per-slot lengths, on both sides."""
    jp, tm = models
    rng = np.random.RandomState(1)
    S_pad, true_len = 64, np.array([29, 64], np.int32)
    tokens = rng.randint(0, 128, size=(2, S_pad)).astype(np.int32)
    j_logits, j_kvs = jl.prefill_forward(jp, jnp.asarray(tokens), jnp.asarray(true_len), J_CFG)
    with torch.no_grad():
        t_logits, t_kvs = tl.prefill_forward(tm, torch.from_numpy(tokens).long(),
                                             torch.from_numpy(true_len))
    for b, n in enumerate(true_len):  # rows past true_len are padding
        np.testing.assert_allclose(t_logits[b, :n].numpy(), np.asarray(j_logits[b, :n]),
                                   rtol=0, atol=TOL)

    j_kv = jkv.KVCacheConfig(n_layers=2, n_kv_heads=2, head_dim=32, max_seq=128, n_slots=2,
                             compute_dtype=jnp.float32, block_kv=128)
    t_kv = tkv.KVCacheConfig(n_layers=2, n_kv_heads=2, head_dim=32, max_seq=128, n_slots=2,
                             compute_dtype=torch.float32)
    j_caches = [jkv.write_kv(c, k, v, jnp.zeros((2,), jnp.int32), j_kv)
                for c, (k, v) in zip(jkv.init_cache(j_kv), j_kvs)]
    t_caches = [tkv.write_kv(c, k, v, torch.zeros(2, dtype=torch.int32), t_kv)
                for c, (k, v) in zip(tkv.init_cache(t_kv, device="cpu"), t_kvs)]
    lens = true_len.copy()
    toks = rng.randint(0, 128, size=(2,)).astype(np.int32)
    for _ in range(3):
        j_out, j_caches = jl.decode_step(jp, jnp.asarray(toks), J_CFG, j_caches,
                                         jnp.asarray(lens), j_kv)
        with torch.no_grad():
            t_out, t_caches = tl.decode_step(tm, torch.from_numpy(toks).long(), t_caches,
                                             torch.from_numpy(lens), t_kv)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=TOL)
        for jc, tc in zip(j_caches, t_caches):
            for b, n in enumerate(lens + 1):
                np.testing.assert_allclose(tc["k"][b, :, :n, :32].numpy(),
                                           np.asarray(jc["k"])[b, :, :n, :32], rtol=0, atol=TOL)
                assert not tc["k"][..., 32:].any()   # padded to the kernels' 64
        toks = np.asarray(j_out).argmax(-1).astype(np.int32)
        lens = lens + 1


def test_rope_scaling_matches_jax():
    pos = np.arange(0, 300, 7, dtype=np.int32)[None]
    factors = (8.0, 1.0, 4.0, 64.0)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 64, 500000.0, factors)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 64, 500000.0, factors)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)


def test_qkv_bias_and_qk_norm_keys_convert(models):
    """Optional layer keys (Qwen2 biases, Qwen3 q/k norms) are copied and
    used exactly as in JAX."""
    jp, _ = models
    rng = np.random.RandomState(2)
    layers = []
    for layer in jp["layers"]:
        layer = dict(layer)
        layer["bq"] = jnp.asarray(rng.normal(0, 0.1, (128,)), jnp.float32)
        layer["bk"] = jnp.asarray(rng.normal(0, 0.1, (64,)), jnp.float32)
        layer["bv"] = jnp.asarray(rng.normal(0, 0.1, (64,)), jnp.float32)
        layer["q_norm"] = jnp.asarray(1 + rng.normal(0, 0.1, (32,)), jnp.float32)
        layer["k_norm"] = jnp.asarray(1 + rng.normal(0, 0.1, (32,)), jnp.float32)
        layers.append(layer)
    jp2 = dict(jp, layers=layers)
    tm2 = llama_from_jax_params(jax.tree.map(np.asarray, jp2), T_CFG, device="cpu")
    tokens = rng.randint(0, 128, size=(1, 20))
    j = np.asarray(jl.forward(jp2, jnp.asarray(tokens, jnp.int32), J_CFG))
    with torch.no_grad():
        t = tl.forward(tm2, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


def test_moe_layers_raise(models):
    """MoE layers are ported (tests/test_torch_moe.py), under an MoEConfig:
    a router tree with a plain LlamaConfig, or a tree that routes in some
    layers only, raises."""
    jp, _ = models
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"][0]["router"] = np.zeros((128, 4), np.float32)
    with pytest.raises(ValueError, match="MoEConfig"):
        llama_from_jax_params(tree, T_CFG, device="cpu")


@pytest.mark.parametrize("qname", ["int8", "float8_e4m3fn"])
def test_weight_quant_qmatmul_matches_jax(qname):
    """Weight-only quantization: same int8/fp8 values and scales, and the
    dequant-in-epilogue matmul within 1e-4 (fp32 sums of 128 terms)."""
    from fa2_triton_tpu.ops import quant as jq
    from fa2_triton_tpu_torch.ops import quant as tq

    rng = np.random.RandomState(5)
    w = rng.normal(0, 0.05, (128, 96)).astype(np.float32)
    x = rng.normal(0, 1.0, (3, 128)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w), getattr(jnp, qname))
    tw = tq.quantize_weight(torch.from_numpy(w), getattr(torch, qname))
    np.testing.assert_array_equal(tw["qvalues"].float().numpy(),
                                  np.asarray(jw["qvalues"]).astype(np.float32))
    np.testing.assert_allclose(tw["qscale"].numpy(), np.asarray(jw["qscale"]), rtol=1e-7, atol=0)
    np.testing.assert_allclose(tq.qmatmul(torch.from_numpy(x), tw).numpy(),
                               np.asarray(jq.qmatmul(jnp.asarray(x), jw)), rtol=0, atol=TOL)
    assert torch.equal(tq.qmatmul(torch.from_numpy(x), torch.from_numpy(w)),
                       torch.from_numpy(x) @ torch.from_numpy(w))
