"""The port's LoRA adapters (`models/lora.py`) against the JAX package's, on
the JAX suite's LLaMA config (vocab 128, dim 64, 2 layers, 4 / 2 heads,
hidden 96), fp32, with the JAX adapters converted by `lora_from_jax`.

Merged weights within 1e-6 (a rank-4 fp32 dot per entry, summed in another
order), logits within 1e-4 and adapter gradients within 1e-5, as in
`test_torch_llama.py` / `test_torch_train.py`; a zero-initialized adapter
leaves the model bit for bit as it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.models import lora as jlora

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models import lora as tlora  # noqa: E402
from fa2_triton_tpu_torch.models.convert import (  # noqa: E402
    llama_from_jax_params, llama_to_jax_params,
)
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402

MERGE_TOL, LOGIT_TOL, GRAD_TOL, LP_TOL = 1e-6, 1e-4, 1e-5, 1e-4
KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=96,
          max_seq_len=64)
J_CFG = jl.LlamaConfig(dtype=jnp.float32, **KW)
T_CFG = tl.LlamaConfig(dtype=torch.float32, **KW)


@pytest.fixture(scope="module")
def setup():
    """JAX params and adapters (B perturbed so the adapter changes the
    model, as the JAX suite does), the merged tree, the adapter gradients,
    and the port's model."""
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    lo = jlora.init_lora(jax.random.PRNGKey(1), jp, rank=4)
    lo = jax.tree.map(lambda x: x + 0.01 if x.shape[0] == 4 else x, lo)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 33), 0, 128)).astype(np.int64)
    merged = jax.tree.map(np.asarray, jlora.merge_lora(jp, lo))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, l, t: jlora.lora_loss_fn(p, l, t, J_CFG, jl.loss_fn), argnums=1))
    loss, grads = grad_fn(jp, lo, jnp.asarray(tokens))
    logits = np.asarray(jax.jit(lambda p, t: jl.forward(p, t, J_CFG))(
        jlora.merge_lora(jp, lo), jnp.asarray(tokens)))
    model = llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")
    model.requires_grad_(False)
    ref = {"merged": merged, "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
           "logits": logits, "tokens": tokens, "lora": jax.tree.map(np.asarray, lo)}
    return model, ref


def test_merge_matches_jax_on_converted_adapters(setup):
    model, ref = setup
    lora = tlora.lora_from_jax(ref["lora"], device="cpu")
    merged = llama_to_jax_params(tlora.merged_model(model, lora))
    for li, layer in enumerate(ref["merged"]["layers"]):
        for key, want in layer.items():
            tol = MERGE_TOL if key in tlora.DEFAULT_TARGETS else 0.0
            np.testing.assert_allclose(merged["layers"][li][key], want, rtol=0, atol=tol,
                                       err_msg=f"layer {li} {key}")
    with torch.no_grad():
        logits = tl.forward(tlora.merge_lora(model, lora), torch.from_numpy(ref["tokens"]))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0, atol=LOGIT_TOL)
    assert tlora.lora_to_jax(lora)["layers"][1]["wo"]["b"].shape == (4, 64)


def test_zero_init_is_identity(setup):
    model, ref = setup
    lora = tlora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    assert sorted(lora.layers[0]) == sorted(tlora.DEFAULT_TARGETS)
    assert lora.layers[0]["wq"]["a"].shape == (64, 4) and not lora.layers[0]["wq"]["b"].any()
    tokens = torch.from_numpy(ref["tokens"])
    with torch.no_grad():
        torch.testing.assert_close(tl.forward(tlora.merge_lora(model, lora), tokens),
                                   tl.forward(model, tokens), rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_adapter_gradients_match_jax_and_the_base_is_untouched(setup, remat):
    """`lora_loss_fn`'s loss and adapter gradients against
    jax.grad(lora_loss_fn, argnums=1); with remat the checkpointed layers
    recompute on the merged weights. The base gets no gradient, and an
    AdamW step on the adapters leaves it bit for bit as it was."""
    model, ref = setup
    cfg = tl.LlamaConfig(dtype=torch.float32, remat=remat, **KW)
    base = llama_from_jax_params(llama_to_jax_params(model), cfg, device="cpu")
    base.requires_grad_(False)
    before = {n: p.clone() for n, p in base.named_parameters()}
    lora = tlora.lora_from_jax(ref["lora"], device="cpu")
    loss = tlora.lora_loss_fn(base, lora, torch.from_numpy(ref["tokens"]), tl.loss_fn)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=0, atol=GRAD_TOL)
    got = tlora.lora_to_jax(lora, grads=True)
    for li, layer in enumerate(ref["grads"]["layers"]):
        for key, ab in layer.items():
            for k, want in ab.items():
                np.testing.assert_allclose(got["layers"][li][key][k], want, rtol=0, atol=GRAD_TOL,
                                           err_msg=f"layer {li} {key}.{k}")
    torch.optim.AdamW(lora.parameters(), lr=1e-2).step()
    for n, p in base.named_parameters():
        assert p.grad is None and torch.equal(p, before[n]), n
    with pytest.raises(ValueError, match="freeze"):
        tlora.lora_loss_fn(base.requires_grad_(True), lora, torch.from_numpy(ref["tokens"]),
                           tl.loss_fn)


def test_adapter_training_reduces_loss(setup):
    model, ref = setup
    lora = tlora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    tokens = torch.from_numpy(ref["tokens"])
    opt = torch.optim.SGD(lora.parameters(), lr=0.1)
    losses = []
    for _ in range(6):
        loss = tlora.lora_loss_fn(model, lora, tokens, tl.loss_fn)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("paged", [False, True])
def test_merged_model_serves_through_engine(setup, paged):
    """The merged model through the Engine equals greedy decoding by its
    own full forward, each top-1 margin above 10x the log-prob tolerance."""
    model, ref = setup
    merged = tlora.merged_model(model, tlora.lora_from_jax(ref["lora"], device="cpu"))
    prompt = [5, 6, 7, 8]
    engine = Engine(merged, T_CFG, n_slots=2, max_seq=128, paged=paged)
    req = engine.submit(prompt, max_new_tokens=4)
    engine.run()
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(4):
            logits = tl.forward(merged, torch.tensor([toks]))[0, -1]
            top2 = logits.topk(2).values
            assert float(top2[0] - top2[1]) > 10 * LP_TOL
            toks.append(int(logits.argmax()))
    assert req.out_tokens == toks[len(prompt):]
