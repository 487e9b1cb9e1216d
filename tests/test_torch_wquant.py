"""Weight-only quantized models (`models/llama.py:quantize_model_params`)
against the JAX package's, on the JAX suite's config (vocab 128, dim 64, 2
layers, 4 / 2 heads, hidden 128), fp32 activations.

The int8 and fp8 values and their scales must equal JAX's bit for bit (the
same fp32 amax, division, round-half-to-even and clip; fp8 by a plain
cast). The quantized forward's logits must lie within 1e-4 of JAX's
quantized forward (the same fp32 products summed in another order), and the
Engine must serve the quantized model as its own forward decodes greedily.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.ops.quant import QuantizedWeight, is_quantized_weight  # noqa: E402
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402

LOGIT_TOL, LP_TOL = 1e-4, 1e-4
KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
          max_seq_len=128)
J_CFG = jl.LlamaConfig(dtype=jnp.float32, **KW)
T_CFG = tl.LlamaConfig(dtype=torch.float32, **KW)
QDTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(scope="module")
def setup():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    model = llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, 128)).astype(np.int64)
    forward = jax.jit(lambda p, t: jl.forward(p, t, J_CFG))
    ref = {}
    for name, (jq, _) in QDTYPES.items():
        qp = jl.quantize_model_params(jp, jq)
        ref[name] = (qp, np.asarray(forward(qp, jnp.asarray(tokens))))
    return model, tokens, ref


def _bits(a) -> np.ndarray:
    """Values as raw bits: fp8 has no numpy dtype of its own in torch."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


@pytest.mark.parametrize("qname", list(QDTYPES))
def test_quantized_weights_equal_jax_bitwise(setup, qname):
    model, _, ref = setup
    qp, _ = ref[qname]
    qm = tl.quantize_model_params(model, QDTYPES[qname][1])
    pairs = [(qm.lm_head, qp["lm_head"])]
    for layer, jlayer in zip(qm.layers, qp["layers"]):
        for key in tl.QUANTIZABLE_KEYS[:-1]:
            pairs.append((getattr(layer, key), jlayer[key]))
    for got, want in pairs:
        assert isinstance(got, QuantizedWeight) and is_quantized_weight(got)
        np.testing.assert_array_equal(_bits(got["qvalues"]), _bits(want["qvalues"]))
        np.testing.assert_array_equal(got["qscale"].numpy(), np.asarray(want["qscale"]))
    # The embedding and norms are shared, and the source model is unchanged.
    assert qm.embed is model.embed and qm.layers[1].mlp_norm is model.layers[1].mlp_norm
    assert isinstance(model.layers[0].wq, torch.nn.Parameter)
    assert {n.rsplit(".", 1)[-1] for n, _ in qm.named_buffers()} == {"qvalues", "qscale"}


@pytest.mark.parametrize("qname", list(QDTYPES))
def test_quantized_forward_matches_jax(setup, qname):
    model, tokens, ref = setup
    qm = tl.quantize_model_params(model, QDTYPES[qname][1])
    with torch.no_grad():
        logits = tl.forward(qm, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), ref[qname][1], rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_serves_the_quantized_model(setup, paged):
    """int8 weights through the Engine equal greedy decoding by the
    quantized model's own full forward, each top-1 margin above 10x the
    log-prob tolerance."""
    model, _, _ = setup
    qm = tl.quantize_model_params(model, torch.int8)
    prompt = [3, 17, 88, 54, 9]
    engine = Engine(qm, T_CFG, n_slots=2, max_seq=128, paged=paged)
    req = engine.submit(prompt, max_new_tokens=5)
    engine.run()
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(5):
            logits = tl.forward(qm, torch.tensor([toks]))[0, -1]
            top2 = logits.topk(2).values
            assert float(top2[0] - top2[1]) > 10 * LP_TOL
            toks.append(int(logits.argmax()))
    assert req.out_tokens == toks[len(prompt):]
