"""The port's GPT-2 family (`models/gpt2.py`, `models/convert.py`'s GPT-2
pair) against the JAX package's, on the CPU, at `tests/test_models_extra.py`'s
tiny config (vocab 256, dim 128, 2 layers, 4 heads, 256 hidden, 128
positions, fp32), tied and untied.

Tolerances (fp32 on both sides; sums in another order, the JAX attention in
interpret mode): logits 1e-4, loss 1e-5, gradients 1e-4 x (1 + max |grad|)
per leaf; the cached decode against JAX's `forward_with_cache` 1e-4 and
against the port's own full forward 1e-4. The JAX references are computed
once per module and config.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import GPT2Config as JGPT2Config
from fa2_triton_tpu.models import gpt2 as jg

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import GPT2Config, gpt2  # noqa: E402
from fa2_triton_tpu_torch.models.convert import (  # noqa: E402
    gpt2_from_jax_params, gpt2_to_jax_params)
from fa2_triton_tpu_torch.ops import flash_fwd  # noqa: E402

KW = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, hidden_dim=256, max_seq_len=128)
B, S = 2, 33
PREFILL, TOTAL = 24, 28


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, KW["vocab_size"], shape)


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def pair(request):
    """(JAX params, port model, port cfg, JAX reference): a random port
    model (its init is quick; JAX's takes seconds) carried into the JAX tree
    and back, and the loss, gradients and logits of one jitted
    value_and_grad of the JAX model."""
    tie = request.param
    jcfg = JGPT2Config(dtype=jnp.float32, tie_embeddings=tie, **KW)
    cfg = GPT2Config(dtype=torch.float32, tie_embeddings=tie, **KW)
    tree = gpt2_to_jax_params(gpt2.init_params(torch.Generator().manual_seed(0), cfg))
    jp = jax.tree.map(jnp.asarray, tree)
    model = gpt2_from_jax_params(tree, cfg, device="cpu")
    toks = jnp.asarray(_tokens(1, (B, S)))

    def f(p):
        return jg.loss_fn(p, toks, jcfg), jg.forward(p, toks[:, :-1], jcfg)

    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
    ref = {"loss": float(loss), "logits": np.asarray(logits), "grads": jax.tree.map(np.asarray, grads)}
    return jp, model, cfg, ref


def test_forward_loss_and_grads_match_jax(pair):
    _, model, _, ref = pair
    toks = torch.from_numpy(_tokens(1, (B, S)))
    with torch.no_grad():
        logits = gpt2.forward(model, toks[:, :-1])
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0, atol=1e-4)
    model.zero_grad()
    loss = gpt2.loss_fn(model, toks)
    loss.backward()
    assert abs(loss.item() - ref["loss"]) <= 1e-5
    got = gpt2_to_jax_params(model, grads=True)
    assert ("lm_head" in got) == (not model.cfg.tie_embeddings)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(ref["grads"]))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        want = flat_want[path]
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * (1 + np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_cached_decode_matches_the_full_forward(pair):
    """A 24-token prefill, then 4 width-1 steps (B 2): each step's logits
    equal the full forward's at its position."""
    _, model, cfg, _ = pair
    toks = torch.from_numpy(_tokens(2, (B, TOTAL)))
    caches = gpt2.init_kv_cache(cfg, B, 64, device="cpu")
    n0 = flash_fwd.LAUNCHES
    with torch.no_grad():
        full = gpt2.forward(model, toks)
        logits, _ = gpt2.forward_with_cache(model, toks[:, :PREFILL], cfg, caches, 0)
        torch.testing.assert_close(logits, full[:, :PREFILL], rtol=0, atol=1e-4)
        for t in range(PREFILL, TOTAL):
            logits, _ = gpt2.forward_with_cache(model, toks[:, t:t + 1], cfg, caches, t)
            torch.testing.assert_close(logits[:, 0], full[:, t], rtol=0, atol=1e-4)
    assert flash_fwd.LAUNCHES == n0
    assert not caches[0][0][:, :, TOTAL:].any()     # only the steps' rows are written


def test_cached_decode_matches_jax():
    """The same prefill and steps against JAX's `forward_with_cache` (tied
    head; JAX's caches are BSHD, the port's BHSD)."""
    jcfg = JGPT2Config(dtype=jnp.float32, **KW)
    cfg = GPT2Config(dtype=torch.float32, **KW)
    model = gpt2.init_params(torch.Generator().manual_seed(3), cfg)
    jp = jax.tree.map(jnp.asarray, gpt2_to_jax_params(model))
    toks = _tokens(4, (B, TOTAL))
    step = jax.jit(functools.partial(jg.forward_with_cache, cfg=jcfg))
    jc, tc = jg.init_kv_cache(jcfg, B, 64), gpt2.init_kv_cache(cfg, B, 64, device="cpu")
    with torch.no_grad():
        for lo, hi in [(0, PREFILL)] + [(t, t + 1) for t in range(PREFILL, TOTAL)]:
            want, jc = step(jp, jnp.asarray(toks[:, lo:hi]), caches=jc, cache_len=jnp.int32(lo))
            got, _ = gpt2.forward_with_cache(model, torch.from_numpy(toks[:, lo:hi]), cfg, tc, lo)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc[1][1][:, :, :TOTAL].numpy(),
                               np.asarray(jc[1][1])[:, :TOTAL].transpose(0, 2, 1, 3),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_convert_round_trip(tie):
    """JAX tree -> GPT2Model -> JAX tree is the identity in fp32; bf16 keeps
    the weights' bf16 values and the norms and biases in fp32."""
    cfg = GPT2Config(dtype=torch.float32, tie_embeddings=tie, **KW)
    rng = np.random.RandomState(5)
    tree = gpt2_to_jax_params(gpt2.GPT2Model(cfg, device="cpu"))
    tree = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
    back = gpt2_to_jax_params(gpt2_from_jax_params(tree, cfg, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    m16 = gpt2_from_jax_params(tree, cfg, device="cpu", dtype=torch.bfloat16)
    assert m16.wte.dtype == torch.bfloat16 and m16.layers[0].ln1_g.dtype == torch.float32
    np.testing.assert_array_equal(m16.layers[1].b_fc.detach().numpy(), tree["layers"][1]["b_fc"])
    np.testing.assert_array_equal(m16.wpe.detach().float().numpy(),
                                  torch.from_numpy(tree["wpe"]).bfloat16().float().numpy())
    other = GPT2Config(dtype=torch.float32, tie_embeddings=not tie, **KW)
    with pytest.raises(ValueError, match="lm_head"):
        gpt2_from_jax_params(tree, other, device="cpu")


def test_positions_past_the_learned_ones_raise():
    """JAX's gather of wpe clamps a position >= max_seq_len to the last row
    (ROADMAP.md queue C); the port raises."""
    cfg = GPT2Config(dtype=torch.float32, **KW)
    model = gpt2.init_params(torch.Generator().manual_seed(6), cfg)
    n = cfg.max_seq_len
    with torch.no_grad():
        gpt2.forward(model, torch.zeros(1, n, dtype=torch.long))        # positions 0..n-1
        with pytest.raises(ValueError, match="position"):
            gpt2.forward(model, torch.zeros(1, n + 1, dtype=torch.long))
        with pytest.raises(ValueError, match="position"):
            gpt2.forward(model, torch.zeros(1, 2, dtype=torch.long), positions=torch.tensor([0, n]))
        caches = gpt2.init_kv_cache(cfg, 1, n + 8, device="cpu")
        gpt2.forward_with_cache(model, torch.zeros(1, 1, dtype=torch.long), cfg, caches, n - 1)
        with pytest.raises(ValueError, match="position"):
            gpt2.forward_with_cache(model, torch.zeros(1, 1, dtype=torch.long), cfg, caches, n)
