from fa2_triton_tpu_torch.ops.attention import flash_attn_func
from fa2_triton_tpu_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from fa2_triton_tpu_torch.ops.flash_bwd import flash_attn_backward, flash_attn_backward_plain
from fa2_triton_tpu_torch.ops.flash_fwd import flash_attn_forward, flash_attn_forward_plain
from fa2_triton_tpu_torch.ops.quant import dequantize_tensor, quantize_kv, quantize_tensor
from fa2_triton_tpu_torch.ops.reference import construct_local_mask, flash_attn_reference
from fa2_triton_tpu_torch.ops.tuning import BlockSizes, choose_block_sizes
from fa2_triton_tpu_torch.ops.varlen import (
    flash_attn_blocksparse_func,
    flash_attn_varlen_func,
    pack_padded_batch,
    unpack_padded_batch,
)

__all__ = [
    "flash_attn_func",
    "flash_attn_reference",
    "construct_local_mask",
    "BlockSizes",
    "choose_block_sizes",
    "flash_attn_forward",
    "flash_attn_forward_plain",
    "flash_attn_backward",
    "flash_attn_backward_plain",
    "decode_attention",
    "decode_attention_plain",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "quantize_tensor",
    "dequantize_tensor",
    "quantize_kv",
    "flash_attn_varlen_func",
    "flash_attn_blocksparse_func",
    "pack_padded_batch",
    "unpack_padded_batch",
]
