from fa2_triton_tpu_torch.models import convert
from fa2_triton_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
    decode_step,
    forward,
    init_params,
    loss_fn,
    paged_decode_step,
    prefill_forward,
)

__all__ = [
    "LlamaConfig", "LlamaModel", "init_params", "forward", "prefill_forward",
    "decode_step", "paged_decode_step", "loss_fn", "convert",
]
