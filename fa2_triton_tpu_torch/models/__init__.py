from fa2_triton_tpu_torch.models import convert, gpt2, lora, moe
from fa2_triton_tpu_torch.models.gpt2 import GPT2Config
from fa2_triton_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
    decode_step,
    forward,
    init_params,
    loss_fn,
    paged_decode_step,
    prefill_forward,
    quantize_model_params,
)
from fa2_triton_tpu_torch.models.moe import MoEConfig

__all__ = [
    "LlamaConfig", "LlamaModel", "init_params", "forward", "prefill_forward",
    "decode_step", "paged_decode_step", "loss_fn", "quantize_model_params", "convert", "gpt2",
    "GPT2Config", "moe", "MoEConfig", "lora",
]
