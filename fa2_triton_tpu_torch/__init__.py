"""fa2_triton_tpu_torch — the PyTorch + CUDA port of fa2_triton_tpu.

Same module layout as the JAX package, so every ported module has one named
counterpart (`fa2_triton_tpu_torch.ops.decode` <-> `fa2_triton_tpu.ops.decode`).
Plain tensor code is PyTorch; the Pallas TPU kernels on the ported path are
CUDA C++ kernels for Hopper (sm_90a) in `csrc/`, built with nvcc at first use
(`ops/_build.py`). Ported so far: the serving path (prefill attention
`ops/flash_fwd.py`, decode attention `ops/decode.py` over a contiguous or
paged KV cache stored in the compute dtype, int8 or fp8, the LLaMA model
and the continuous-batching `Engine` with its `paged` / `qdtype` modes and
preemption), the training path (the backward kernels `ops/flash_bwd.py`
behind `flash_attn_func`'s autograd, `loss_fn`, remat and
`examples/train.py`), packed varlen / block-sparse attention
(`ops/varlen.py`, forward and backward kernels), and attention dropout in
every attention kernel (the JAX package's counter-hash stream,
`utils/rng.py`, bit for bit) with the `FlashSelfAttention` module
(`layers.py`), chunked prefill, the prefix cache, sampling and speculative
decoding, and the model zoo (`models/`: LLaMA, GPT-2, the Mixtral-style
MoE family, LoRA, weight-only int8 / fp8 models, the Hugging Face
loaders), and the parallel layer over `torch.distributed` (`parallel/`:
meshes and spec tables, TP / ring / Ulysses attention, the Engine's TP mode
and `DataParallelEngine`). This package never imports JAX.
"""

from fa2_triton_tpu_torch.ops import (
    flash_attn_blocksparse_func,
    flash_attn_func,
    flash_attn_reference,
    flash_attn_varlen_func,
    pack_padded_batch,
    unpack_padded_batch,
)
from fa2_triton_tpu_torch.layers import FlashSelfAttention

__all__ = [
    "FlashSelfAttention",
    "flash_attn_func",
    "flash_attn_reference",
    "flash_attn_varlen_func",
    "flash_attn_blocksparse_func",
    "pack_padded_batch",
    "unpack_padded_batch",
]
__version__ = "0.1.0"
