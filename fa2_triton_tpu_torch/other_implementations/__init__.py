"""Third-party attention baselines for benchmarking (PyTorch port of
`fa2_triton_tpu.other_implementations`).

Yardsticks only, never on the port's path and never the numerics oracle
(that is `fa2_triton_tpu_torch.ops.reference`). On the card the analogous
comparison points of the JAX package's XLA dense attention and JAX's own
Pallas flash kernel are

* `dense_attention`      — plain, unfused PyTorch attention, one head at a
  time under `torch.utils.checkpoint`;
* `sdpa_flash_attention` — `scaled_dot_product_attention` restricted to its
  flash backend (PyTorch's own flash-attention kernel);
* `flex_attention`       — `torch.nn.attention.flex_attention` with a
  causal block mask (eager on the CPU, compiled on the card).

All take the BSHD layout of `fa2_triton_tpu_torch.flash_attn_func`.
"""
from fa2_triton_tpu_torch.other_implementations.baselines import (
    dense_attention,
    flex_attention,
    sdpa_flash_attention,
)

__all__ = ["dense_attention", "sdpa_flash_attention", "flex_attention"]
