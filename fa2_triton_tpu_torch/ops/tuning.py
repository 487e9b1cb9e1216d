"""Static block-size selection (PyTorch port of `fa2_triton_tpu.ops.tuning`).

The JAX package pads each sequence to the larger of its forward and
backward blocks and routes its causal schedules on that padded shape; its
blocks are a v5e-swept prior that a persisted per-chip table overrides
(`ops/autotune.py`). The port keeps this prior as its own pure-Python copy,
consulting `autotune.lookup` exactly where JAX does, because the padded
shape is what the causal routing gates read (`flash_fwd.jax_padded_shape`).

On the card a `BlockSizes` decides only that padded shape, and so the
route: it does not decide tiles. The CUDA tiles are compile-time (64 rows,
`flash_fwd.TILE_ROWS`; the kv tiles `BKV` of `csrc/bwd_mma.cuh`), and the
kernels pad nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from fa2_triton_tpu_torch.ops.autotune import lookup, warn_if_unswept
from fa2_triton_tpu_torch.utils import round_up_to_multiple


@dataclass(frozen=True)
class BlockSizes:
    block_q: int
    block_kv: int
    # Backward passes use their own tiling.
    block_q_bwd: int
    block_kv_bwd: int
    # The TPU kernels' kv sub-tiles per forward block and sub-tiles per
    # backward block; kept for the JAX package's signature, unused here.
    unroll_kv: int = 4
    unroll_bwd: int = 2

    def __post_init__(self):
        for v in (self.block_q, self.block_kv, self.block_q_bwd, self.block_kv_bwd):
            if v <= 0 or v % 128:
                raise ValueError(f"blocks must be positive multiples of 128, got {self}")


def _waste_aware(seqlen: int, candidates, max_waste_frac: float = 0.125) -> int:
    """Largest candidate block whose pad-to-multiple waste stays under
    `max_waste_frac` of the sequence (candidates descending)."""
    sp = round_up_to_multiple(max(seqlen, 1), 128)
    for cand in candidates:
        c = min(cand, sp)
        padded = round_up_to_multiple(sp, c)
        if padded - seqlen <= max(seqlen, 1) * max_waste_frac:
            return c
    return min(candidates[-1], sp)


def choose_block_sizes(seqlen_q: int, seqlen_k: int, head_dim_padded: int,
                       dtype_bits: int = 16, causal: bool = False,
                       has_bias: bool = False,
                       has_window: bool = False,
                       has_varlen: bool = False,
                       chip: Optional[str] = None) -> BlockSizes:
    """JAX's blocks (`fa2_triton_tpu/ops/tuning.py:53`): the chip's table
    first (`fwd` entries, 16-bit only; `fwd+bias` / `fwd+window` variants),
    then the v5e prior. `chip` defaults to `autotune.detect_chip()`."""
    warn_if_unswept(chip)
    if not (has_bias or has_window or has_varlen) and dtype_bits <= 16:
        ov = lookup("fwd", causal, head_dim_padded, max(seqlen_q, seqlen_k), chip=chip)
        if ov is not None:
            bq, bkv, u = ov
            bq = min(bq, round_up_to_multiple(max(seqlen_q, 1), 128))
            bkv = min(bkv, round_up_to_multiple(max(seqlen_k, 1), 128))
            if head_dim_padded <= 128:
                bq_b, bkv_b = (1024, 1024) if causal else (512, 2048)
                bq_b = min(bq_b, round_up_to_multiple(max(seqlen_q, 1), 128))
                bkv_b = min(bkv_b, round_up_to_multiple(max(seqlen_k, 1), 128))
                bq_b, bkv_b = _compatible(bq, bq_b), _compatible(bkv, bkv_b)
            else:
                bq_b = _divisor_block(bq, 256)
                bkv_b = _divisor_block(bkv, 256)
            return BlockSizes(block_q=bq, block_kv=bkv, block_q_bwd=bq_b,
                              block_kv_bwd=bkv_b, unroll_kv=u,
                              unroll_bwd=1 if causal else 2)
    unroll_kv = 4
    if dtype_bits <= 16 and not has_varlen and (has_bias or has_window):
        ov = lookup("fwd", causal, head_dim_padded, max(seqlen_q, seqlen_k), chip=chip,
                    variant="bias" if has_bias else "window")
        if ov is not None:
            bq_v, bkv_v, u_v = ov
            bq_v = min(bq_v, round_up_to_multiple(max(seqlen_q, 1), 128))
            bkv_v = min(bkv_v, round_up_to_multiple(max(seqlen_k, 1), 128))
            return BlockSizes(block_q=bq_v, block_kv=bkv_v,
                              block_q_bwd=_divisor_block(bq_v, 512),
                              block_kv_bwd=_divisor_block(bkv_v, 512),
                              unroll_kv=u_v, unroll_bwd=1 if causal else 2)
    if head_dim_padded <= 128:
        if has_bias:
            bq, bkv = 512, _waste_aware(seqlen_k, (1024, 512, 256, 128))
        elif causal and has_window:
            bq = _waste_aware(seqlen_q, (1024, 512, 256, 128))
            bkv = _waste_aware(seqlen_k, (2048, 1024, 512, 256, 128))
        elif causal:
            bq = _waste_aware(seqlen_q, (1024, 512, 256, 128))
            bkv = _waste_aware(seqlen_k, (1024, 512, 256, 128))
            unroll_kv = 1
        elif has_varlen:
            bkv = _waste_aware(seqlen_k, (1024, 512, 256, 128))
            bq = _waste_aware(seqlen_q, (512, 256, 128))
            if dtype_bits >= 32:
                bq, bkv = min(bq, 512), min(bkv, 512)
            return BlockSizes(block_q=bq, block_kv=bkv,
                              block_q_bwd=bq, block_kv_bwd=bkv,
                              unroll_kv=1, unroll_bwd=2)
        else:
            bkv = _waste_aware(seqlen_k, (4096, 2048, 1024, 512, 256, 128))
            bq_cand = max(128, min(1024, (512 * 4096) // bkv) // 128 * 128)
            bq = _waste_aware(seqlen_q, (bq_cand, 512, 256, 128))
            if bkv < 2048:
                unroll_kv = 1
    elif head_dim_padded <= 256:
        if causal and not (has_bias or has_window):
            bq = _waste_aware(seqlen_q, (1024, 512, 256, 128))
            bkv = _waste_aware(seqlen_k, (1024, 512, 256, 128))
            unroll_kv = 2
        else:
            bq = 256
            bkv = _waste_aware(seqlen_k, (4096, 2048, 1024, 512, 256, 128))
            unroll_kv = 8
    else:
        bq, bkv = 128, 256
    if dtype_bits >= 32:
        bq = min(bq, 512)
        bkv = min(bkv, 512 if (causal or has_bias) else 2048)
        unroll_kv = min(unroll_kv, max(1, bkv // 1024))
    bq = min(bq, round_up_to_multiple(max(seqlen_q, 1), 128))
    bkv = min(bkv, round_up_to_multiple(max(seqlen_k, 1), 128))
    if head_dim_padded <= 128:
        bq_b, bkv_b = (1024, 1024) if causal else (512, 2048)
        if dtype_bits >= 32:
            bq_b, bkv_b = 512, 512
        bq_b = min(bq_b, round_up_to_multiple(max(seqlen_q, 1), 128))
        bkv_b = min(bkv_b, round_up_to_multiple(max(seqlen_k, 1), 128))
        bq_b, bkv_b = _compatible(bq, bq_b), _compatible(bkv, bkv_b)
    else:
        bq_b = _divisor_block(bq, 256)
        bkv_b = _divisor_block(bkv, 256)
    return BlockSizes(block_q=bq, block_kv=bkv, block_q_bwd=bq_b,
                      block_kv_bwd=bkv_b, unroll_kv=unroll_kv,
                      unroll_bwd=1 if causal else 2)


def choose_fused_bwd(seqlen_q_pad: int, seqlen_k_pad: int,
                     head_dim_padded: int, causal: bool,
                     dtype_bytes: int = 2, chip: Optional[str] = None):
    """JAX's fused-backward config (`fa2_triton_tpu/ops/tuning.py:193`):
    (block_q, block_kv, sub_kv, unroll), or None for its two-pass kernels.
    The chip's `fused_bwd` entry first, where it divides the padded
    lengths. On the card both are the dq + dk/dv pair; the function is kept
    so that the prior is whole."""
    if head_dim_padded > 256:
        return None
    ov = lookup("fused_bwd", causal, head_dim_padded, seqlen_k_pad, chip=chip)
    if ov is not None:
        bq_o, bkv_o, sub_o, u_o = ov
        if (seqlen_q_pad % bq_o == 0 and seqlen_k_pad % bkv_o == 0
                and bkv_o % sub_o == 0):
            return bq_o, bkv_o, sub_o, u_o
    bkv_max = 4 * 1024 * 1024 // (2 * 4 * head_dim_padded)
    if dtype_bytes >= 4:
        bkv_max //= 4
    if seqlen_k_pad <= bkv_max:
        bkv = seqlen_k_pad
    else:
        bkv = next((c for c in (4096, 2048, 1024)
                    if c <= bkv_max and seqlen_k_pad % c == 0), None)
        if bkv is None:
            return None
    bq = next((c for c in (512, 256, 128) if seqlen_q_pad % c == 0), None)
    if bq is None:
        return None

    def _fits(c):
        return bkv % c == 0 and bq * c * head_dim_padded <= 1 << 26

    if causal:
        sub = next((c for c in (bq, 512, 256, 128) if _fits(c)), None)
        u = 1
    else:
        sub = next((c for c in (1024, 512, 256, 128) if _fits(c)), None)
        u = 2
    if sub is None:
        return None
    return bq, bkv, sub, u


def _compatible(b_fwd: int, b_bwd: int) -> int:
    """Ensure min(fwd, bwd) divides max(fwd, bwd); fall back to b_fwd."""
    lo, hi = min(b_fwd, b_bwd), max(b_fwd, b_bwd)
    return b_bwd if hi % lo == 0 else b_fwd


def _divisor_block(block: int, cap: int) -> int:
    """Largest multiple-of-128 divisor of `block` that is <= cap."""
    if block <= cap:
        return block
    c = (cap // 128) * 128
    while c > 128 and block % c != 0:
        c -= 128
    return c
