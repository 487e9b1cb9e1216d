from fa2_triton_tpu_torch.utils.common import (
    LOG2E,
    cdiv,
    default_softmax_scale,
    next_power_of_2,
    resolve_device,
    round_up_to_multiple,
)
from fa2_triton_tpu_torch.utils.rng import (
    counter_hash_uint32,
    dropout_keep_mask,
    dropout_keep_mask_reference,
    dropout_offsets,
    dropout_threshold,
    packed_dropout_keep_mask,
)

__all__ = [
    "cdiv",
    "round_up_to_multiple",
    "next_power_of_2",
    "default_softmax_scale",
    "LOG2E",
    "resolve_device",
    "counter_hash_uint32",
    "dropout_threshold",
    "dropout_offsets",
    "dropout_keep_mask",
    "dropout_keep_mask_reference",
    "packed_dropout_keep_mask",
]
