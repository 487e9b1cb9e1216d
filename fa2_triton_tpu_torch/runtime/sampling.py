"""Token selection for the serving engine (port of
`fa2_triton_tpu.runtime.sampling`, greedy only).

Greedy (temperature == 0) is exact: first-max argmax, as `jnp.argmax`, and
the chosen token's log-prob under the raw model distribution. Sampling with
temperature > 0 raises: the JAX engine draws token i of a request from
`fold_in(PRNGKey(seed), i)` (threefry), a stream torch cannot reproduce bit
for bit, so its port needs a distributional parity contract (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls. Defaults reproduce greedy decode."""
    temperature: float = 0.0   # 0 => argmax
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1.0 => disabled
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0 or self.top_k < 0 or not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"bad sampling params {self}")


GREEDY = SamplingParams()


def greedy_tokens_with_logprobs(logits: torch.Tensor):
    """Argmax per row [B, V] + the chosen token's raw-model logprob."""
    toks = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return toks, logp.gather(-1, toks[:, None])[:, 0]


def sample_tokens_with_logprobs(logits, temps, top_ks, top_ps, seeds, steps):
    """Per-slot token choice + logprob; only temperature == 0 is ported."""
    if bool((torch.as_tensor(temps) > 0).any()):
        raise NotImplementedError(
            "temperature > 0 sampling is not ported: the JAX threefry stream "
            "cannot be reproduced bit for bit (see ROADMAP.md)")
    return greedy_tokens_with_logprobs(logits)
