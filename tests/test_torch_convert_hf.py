"""The port's Hugging Face loaders (`models/convert.py`) on the tiny random
`transformers` configs of the JAX suite's `tests/test_convert.py`.

For each loader: every leaf of the port's model equals the JAX loader's
tree copied by `llama_from_jax_params` / `gpt2_from_jax_params`, bit for
bit (fp32, and bf16 for one case: both sides round fp32 to bf16 to nearest
even), and the port's fp32 logits match the HF eager forward within the
JAX suite's tolerance (atol 3e-4, rtol 2e-3; 2e-4 where it asks 2e-4).
Gemma2 (windows on the even layers, both softcaps) is also served through
the Engine and must equal HF `generate`, as in the JAX suite.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from fa2_triton_tpu.models import convert as jconvert  # noqa: E402
from fa2_triton_tpu_torch.models import convert as tconvert  # noqa: E402
from fa2_triton_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128, rms_norm_eps=1e-5,
            rope_theta=10000.0, attn_implementation="eager")


def _llama(n_kv):
    torch.manual_seed(n_kv)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        num_key_value_heads=n_kv, tie_word_embeddings=False, **TINY)).eval()


def _tied():
    torch.manual_seed(1)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=True, attn_implementation="eager")).eval()


def _llama3_rope():
    torch.manual_seed(23)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **{**TINY, "max_position_embeddings": 256}, num_key_value_heads=2,
        tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 64})).eval()


def _qwen2(**kw):
    torch.manual_seed(11)
    model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **{**TINY, **kw}, num_key_value_heads=2, tie_word_embeddings=False)).eval()
    with torch.no_grad():   # HF zero-inits the biases
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    return model


def _qwen3():
    torch.manual_seed(41)
    return transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
        **{**TINY, "rms_norm_eps": 1e-6}, num_key_value_heads=2, head_dim=32,
        tie_word_embeddings=False)).eval()


def _phi3():
    torch.manual_seed(43)
    return transformers.Phi3ForCausalLM(transformers.Phi3Config(
        **TINY, num_key_value_heads=2, tie_word_embeddings=False, sliding_window=None,
        pad_token_id=0, bos_token_id=1, eos_token_id=2)).eval()


def _gemma():
    torch.manual_seed(17)
    return transformers.GemmaForCausalLM(transformers.GemmaConfig(
        **TINY, num_key_value_heads=2, head_dim=32, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True)).eval()


def _gemma2(seed=29):
    torch.manual_seed(seed)
    return transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        **{**TINY, "num_hidden_layers": 4}, num_key_value_heads=2, head_dim=16,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True, sliding_window=32,
        query_pre_attn_scalar=24.0, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0)).eval()


def _gpt2():
    torch.manual_seed(3)
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
        attn_implementation="eager")).eval()


# name: (HF model, loader name, token ids shape, logits atol)
CASES = {
    "llama-mha": (lambda: _llama(4), "llama_params_from_hf", (2, 33), 2e-4),
    "llama-gqa": (lambda: _llama(2), "llama_params_from_hf", (2, 33), 2e-4),
    "llama-tied": (_tied, "llama_params_from_hf", (1, 17), 2e-4),
    "llama3-rope": (_llama3_rope, "llama_params_from_hf", (2, 100), 3e-4),
    "qwen2-bias": (_qwen2, "llama_params_from_hf", (2, 29), 3e-4),
    "qwen2-window-layers": (lambda: _qwen2(num_hidden_layers=4, max_position_embeddings=256,
                                           use_sliding_window=True, sliding_window=32,
                                           max_window_layers=2),
                            "llama_params_from_hf", (2, 70), 3e-4),
    "qwen3-qk-norm": (_qwen3, "llama_params_from_hf", (2, 31), 3e-4),
    "phi3": (_phi3, "phi3_params_from_hf", (2, 35), 3e-4),
    "gemma": (_gemma, "gemma_params_from_hf", (2, 27), 3e-4),
    "gemma2": (_gemma2, "gemma2_params_from_hf", (2, 60), 3e-4),
    "gpt2": (_gpt2, "gpt2_params_from_hf", (2, 21), 3e-4),
}


def _numpy(tree):
    """A JAX loader's tree with numpy leaves."""
    return {k: ([{kk: np.asarray(vv) for kk, vv in layer.items()} for layer in v]
                if k == "layers" else np.asarray(v)) for k, v in tree.items()}


def _port_leaves(model):
    return {n: p.detach().float().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", list(CASES))
def test_loader_leaves_equal_jax_and_logits_match_hf(name):
    make, loader, shape, atol = CASES[name]
    hf = make()
    model, cfg = getattr(tconvert, loader)(hf, dtype=torch.float32, device="cpu")
    tree, jcfg = getattr(jconvert, loader)(hf, dtype=jnp.float32)
    tree = _numpy(tree)
    if loader == "gpt2_params_from_hf":
        assert isinstance(model, tgpt2.GPT2Model)
        ref = tconvert.gpt2_from_jax_params(tree, cfg, device="cpu")
    else:
        fields = set(jcfg.__dataclass_fields__) - {"dtype"}
        assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
        ref = tconvert.llama_from_jax_params(tree, cfg, device="cpu")
    got, want = _port_leaves(model), _port_leaves(ref)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=shape)
    with torch.no_grad():
        hf_logits = hf(torch.tensor(ids)).logits.numpy()
        ours = model(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(ours, hf_logits, atol=atol, rtol=2e-3)


@pytest.mark.parametrize("name", ["qwen2-bias", "gemma2"])
def test_bf16_leaves_equal_jax(name):
    """In bf16 both sides round the same fp32 values to nearest even."""
    make, loader, _, _ = CASES[name]
    hf = make()
    model, cfg = getattr(tconvert, loader)(hf, dtype=torch.bfloat16, device="cpu")
    ref = tconvert.llama_from_jax_params(
        _numpy(getattr(jconvert, loader)(hf, dtype=jnp.bfloat16)[0]), cfg, device="cpu")
    assert model.layers[0].wq.dtype == torch.bfloat16
    assert model.layers[0].attn_norm.dtype == torch.float32
    for (n, p), (m, q) in zip(model.named_parameters(), ref.named_parameters()):
        assert n == m and p.dtype == q.dtype and torch.equal(p, q), n


def test_unsupported_hf_options_raise():
    bad = transformers.LlamaConfig(rope_scaling={"rope_type": "yarn", "factor": 4.0})
    with pytest.raises(NotImplementedError, match="yarn"):
        tconvert._rope_factors_from_hf(bad)
    with pytest.raises(NotImplementedError, match="activation"):
        tconvert._gemma_act(transformers.GemmaConfig(hidden_activation="relu"))


@pytest.mark.parametrize("paged", [False, True])
def test_gemma2_served_through_engine_matches_hf_generate(paged):
    """The decode kernels' softcap and alternating windows (a 40-token
    prompt past the 32-token window) against HF generate."""
    hf = _gemma2(37)
    model, cfg = tconvert.gemma2_params_from_hf(hf, dtype=torch.float32, device="cpu")
    prompt = np.random.RandomState(16).randint(0, 128, size=40).tolist()
    with torch.no_grad():
        want = hf.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False,
                           num_beams=1, pad_token_id=0)[0, len(prompt):].tolist()
    engine = Engine(model, cfg, n_slots=2, max_seq=128, paged=paged)
    req = engine.submit(prompt, max_new_tokens=6)
    engine.run()
    assert req.out_tokens == want


def test_loaders_build_on_the_gpu_by_default():
    """Like every constructor of the port, a loader without `device` builds
    on the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.llama_params_from_hf(_tied(), dtype=torch.float32)


def test_bf16_checkpoints_load_where_the_jax_loaders_raise():
    """Published checkpoints ship in bf16. The JAX loaders read the state
    dict through `np.asarray(tensor, np.float32)`, which raises on a bf16
    tensor (ROADMAP.md queue C); the port widens it exactly first, so a bf16
    checkpoint gives the leaves of its fp32 widening."""
    hf = _llama(2)
    widened = tconvert.llama_params_from_hf(hf.to(torch.bfloat16).float(), dtype=torch.bfloat16,
                                            device="cpu")[0]
    with pytest.raises(TypeError, match="BFloat16"):
        jconvert.llama_params_from_hf(hf.to(torch.bfloat16), dtype=jnp.bfloat16)
    model, _ = tconvert.llama_params_from_hf(hf.to(torch.bfloat16), dtype=torch.bfloat16,
                                             device="cpu")
    for (n, p), (m, q) in zip(model.named_parameters(), widened.named_parameters()):
        assert n == m and torch.equal(p, q), n
