"""Counter-hash dropout bits (PyTorch port of `fa2_triton_tpu.utils.rng`).

Dropout bits are a pure integer hash of a global counter, so the CUDA
kernels (`csrc/common.cuh:counter_hash_u32`), the plain twins and the JAX
package all draw the same keep mask from the same seed, bit for bit:

  * dense attention: counter ((b * H + h) * Sq_real + row) * Sk_real + col,
    mod 2**32, over the call's unpadded lengths and the q head;
  * packed varlen / block-sparse attention: the chained hash
    hash(hash(hash(seed, h), row), col) over GLOBAL packed coordinates
    (`packed_dropout_keep_mask`, JAX `ops/varlen.py:_packed_dropout_bits`).

An element is kept iff its bits >= `dropout_threshold(p)`. The seed is an
int32 reinterpreted as uint32, so negative seeds are legal.

torch has no uint32 arithmetic, so values are int64 tensors holding uint32
values in [0, 2**32). A product of two such values overflows int64, so
every multiply by a constant splits the value into 16-bit halves (each
partial product < 2**48) and masks to 32 bits; shifts only ever see masked,
non-negative values.
"""
from __future__ import annotations

from typing import Union

import torch

_M32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B9, 0x21F0AAAD, 0x735A2D97

IntOrTensor = Union[int, torch.Tensor]


def _u32(x: IntOrTensor) -> torch.Tensor:
    """x as an int64 tensor of uint32 values (x mod 2**32)."""
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _mul32(x: torch.Tensor, c: IntOrTensor) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 values x, c, without int64 overflow."""
    c = _u32(c).to(x.device) if isinstance(c, torch.Tensor) else c & _M32
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _M32


def counter_hash_uint32(seed: IntOrTensor, counter: IntOrTensor) -> torch.Tensor:
    """Mix a uint32 counter with a uint32 seed into well-distributed uint32
    bits (a lowbias32-style xorshift-multiply mixer). Broadcasts; returns
    int64 values in [0, 2**32)."""
    counter = _u32(counter)
    x = _mul32(counter, _C1)
    x = (x + _u32(seed).to(x.device)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _C2)
    x = x ^ (x >> 15)
    x = _mul32(x, _C3)
    return x ^ (x >> 15)


def dropout_threshold(dropout_p: float) -> int:
    """uint32 threshold: an element is DROPPED iff its hash < threshold."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


def dropout_counters(batch: IntOrTensor, heads: IntOrTensor, rows: IntOrTensor,
                     cols: IntOrTensor, nheads: int, seqlen_q: int, seqlen_k: int) -> torch.Tensor:
    """((b * nheads + h) * seqlen_q + row) * seqlen_k + col mod 2**32, with
    b / h / row / col broadcastable index tensors."""
    flat = (_mul32(_u32(batch), nheads) + _u32(heads)) & _M32
    flat = (_mul32(flat, seqlen_q) + _u32(rows)) & _M32
    return (_mul32(flat, seqlen_k) + _u32(cols)) & _M32


def dropout_offsets(batch: int, nheads: int, seqlen_q: int, seqlen_k: int,
                    device=None) -> torch.Tensor:
    """Dense counter grid [B, H, Sq, Sk] (uint32 values, int64)."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    return dropout_counters(ar(batch).view(-1, 1, 1, 1), ar(nheads).view(1, -1, 1, 1),
                            ar(seqlen_q).view(1, 1, -1, 1), ar(seqlen_k).view(1, 1, 1, -1),
                            nheads, seqlen_q, seqlen_k)


def dropout_keep_mask(seed: int, dropout_p: float, batch: int, nheads: int,
                      rows: torch.Tensor, cols: torch.Tensor, seqlen_q_real: int,
                      seqlen_k_real: int) -> torch.Tensor:
    """Boolean keep mask [B, H, len(rows), len(cols)] of the dense stream at
    global rows / cols (1-D index tensors: a call's rows placed at q_off,
    its columns at kv_off), on the index tensors' device."""
    dev = rows.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    flat = dropout_counters(ar(batch).view(-1, 1, 1, 1), ar(nheads).view(1, -1, 1, 1),
                            rows.to(torch.int64).view(1, 1, -1, 1),
                            cols.to(torch.int64).view(1, 1, 1, -1),
                            nheads, seqlen_q_real, seqlen_k_real)
    return counter_hash_uint32(seed, flat) >= dropout_threshold(dropout_p)


def dropout_keep_mask_reference(seed: int, dropout_p: float, batch: int, nheads: int,
                                seqlen_q: int, seqlen_k: int, device=None) -> torch.Tensor:
    """Boolean keep mask [B, H, Sq, Sk], bit-identical to the kernels' mask."""
    bits = counter_hash_uint32(seed, dropout_offsets(batch, nheads, seqlen_q, seqlen_k, device))
    return bits >= dropout_threshold(dropout_p)


def packed_dropout_keep_mask(seed: int, dropout_p: float, heads: torch.Tensor,
                             rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Boolean keep mask [len(heads), len(rows), len(cols)] of the packed
    stream: keep iff hash(hash(hash(seed, h), row), col) >= threshold, with
    q heads h and GLOBAL packed rows / columns (1-D index tensors)."""
    s_h = counter_hash_uint32(seed, heads.to(torch.int64).view(-1, 1, 1))
    s_r = counter_hash_uint32(s_h, rows.to(torch.int64).view(1, -1, 1))
    return counter_hash_uint32(s_r, cols.to(torch.int64).view(1, 1, -1)) >= \
        dropout_threshold(dropout_p)
