from fa2_triton_tpu_torch.utils.common import (
    LOG2E,
    cdiv,
    default_softmax_scale,
    next_power_of_2,
    round_up_to_multiple,
)

__all__ = [
    "cdiv",
    "round_up_to_multiple",
    "next_power_of_2",
    "default_softmax_scale",
    "LOG2E",
]
