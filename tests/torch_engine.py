"""Shared pieces of the port's Engine parity tests against the JAX package
(`test_torch_sampling.py`, `test_torch_prefix_cache.py`,
`test_torch_chunked_prefill.py`): the tiny fp32 model of the JAX package's
serving tests (vocab 128, dim 64, 2 layers, 4/2 heads), converted from JAX
params with `llama_from_jax_params`, and a recorder of the margins the
port's Engine chose its tokens by, so that equal tokens are a sound check
and not a coin toss between near ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu_torch.models import llama as tl
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params
from fa2_triton_tpu_torch.runtime import sampling as ts
from fa2_triton_tpu_torch.runtime import serving as tserving

LP_TOL = 1e-4
# A greedy token's top-1 margin must exceed 10x LP_TOL (as
# test_torch_serving.py asks); a sampled token's top-two gap of (adjusted
# logits + Gumbel noise) must exceed DRAW_MARGIN, far above the last bit of
# log / exp, where the two libraries may differ.
GREEDY_MARGIN = 10 * LP_TOL
DRAW_MARGIN = 1e-4
KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
          max_seq_len=512)
J_CFG = jl.LlamaConfig(dtype=jnp.float32, **KW)
T_CFG = tl.LlamaConfig(dtype=torch.float32, **KW)


@pytest.fixture(scope="module")
def models():
    """(JAX params from PRNGKey(0), the same weights as a port model on the CPU)."""
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    return jp, llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")


def choice_margins(logits, temps, top_ks, top_ps, seeds, steps) -> np.ndarray:
    """Per row of logits [B, V]: the top-two gap its token is chosen by, of
    the raw logits for a greedy row, of the adjusted logits + Gumbel noise
    for a sampled one (inf when one entry is left)."""
    logits = torch.as_tensor(logits)
    noisy = ts.adjust_logits(logits, temps, top_ks, top_ps) + ts._gumbel(
        torch.as_tensor(np.asarray(seeds, np.int64)), torch.as_tensor(np.asarray(steps, np.int64)),
        logits.shape[-1])
    x = torch.where(torch.as_tensor(np.asarray(temps) > 0)[:, None], noisy, logits.float())
    top2 = x.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    return torch.where(torch.isinf(top2[:, 1]), torch.full_like(gap, float("inf")), gap).numpy()


class ChoiceMargins:
    """The smallest margin of every token `engine` chooses during its own
    steps, greedy and sampled apart. A decode step's rows are its live
    slots only (idle and mid-prefill slots pick tokens nobody reads)."""

    def __init__(self, engine, monkeypatch):
        self.draw = self.greedy = float("inf")
        self._on, self._decode_rows = False, None
        greedy, sample = tserving.greedy_tokens_with_logprobs, tserving.sample_tokens_with_logprobs
        step, decode = engine.step, engine._decode

        def step_spy():
            self._on = True
            try:
                return step()
            finally:
                self._on = False

        def decode_spy(active):
            self._decode_rows = list(active)
            try:
                return decode(active)
            finally:
                self._decode_rows = None

        def rows(n):
            return self._decode_rows if self._decode_rows is not None else list(range(n))

        def greedy_spy(logits):
            if self._on:
                top2 = logits[rows(logits.shape[0])].topk(2, dim=-1).values
                self.greedy = min(self.greedy, float((top2[:, 0] - top2[:, 1]).min()))
            return greedy(logits)

        def sample_spy(logits, *samp):
            if self._on:
                r = rows(logits.shape[0])
                gaps = choice_margins(logits[r], *(np.asarray(a)[r] for a in samp))
                hot = np.asarray(samp[0])[r] > 0
                self.draw = min([self.draw, *gaps[hot]])
                self.greedy = min([self.greedy, *gaps[~hot]])
            return sample(logits, *samp)

        monkeypatch.setattr(engine, "step", step_spy)
        monkeypatch.setattr(engine, "_decode", decode_spy)
        monkeypatch.setattr(tserving, "greedy_tokens_with_logprobs", greedy_spy)
        monkeypatch.setattr(tserving, "sample_tokens_with_logprobs", sample_spy)

    def check(self):
        assert self.greedy > GREEDY_MARGIN, self.greedy
        assert self.draw > DRAW_MARGIN, self.draw
