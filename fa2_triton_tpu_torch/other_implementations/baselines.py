"""Baseline attention implementations (benchmark comparison kernels), the
PyTorch counterparts of `fa2_triton_tpu/other_implementations/baselines.py`.
BSHD in and out; the causal mask is bottom-right aligned, as the port's."""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _scale(D: int, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)


def _repeat_kv(k, v, Hq: int):
    """k, v with each kv head repeated for its query-head group."""
    group = Hq // k.shape[2]
    if group == 1:
        return k, v
    return k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)


def dense_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense, unfused attention as plain PyTorch code writes it (the JAX
    package's `xla_attention`): one head at a time under
    `torch.utils.checkpoint`, so the [B, Sq, Sk] fp32 scores of only one
    head exist at once and are recomputed in the backward."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    scale = _scale(D, softmax_scale)
    kr, vr = _repeat_kv(k, v, Hq)
    mask = (torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
            if causal else None)

    def one_head(qh, kh, vh):  # [B, S, D]
        s = torch.einsum("btd,bsd->bts", qh * scale, kh)
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s.float(), dim=-1).to(vh.dtype)
        return torch.einsum("bts,bsd->btd", p, vh)

    outs = [checkpoint(one_head, q[:, :, h], kr[:, :, h], vr[:, :, h], use_reentrant=False)
            for h in range(Hq)]
    return torch.stack(outs, dim=2)


def sdpa_flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """`scaled_dot_product_attention` with only its flash backend allowed
    (the JAX package's `jax_flash_attention`: the framework's own flash
    kernel). That backend takes equal head counts, so GQA heads are
    repeated outside it, as JAX's note says; its causal mask is top-left
    aligned, so a causal call needs Sq == Sk (ValueError otherwise)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("SDPA's flash backend aligns causal masks top-left: causal calls need "
                         "seqlen_q == seqlen_k")
    k, v = _repeat_kv(k, v, q.shape[2])
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
            scale=_scale(q.shape[3], softmax_scale))
    return o.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _compiled_flex():
    from torch.nn.attention.flex_attention import flex_attention as flex

    return torch.compile(flex, dynamic=False)


def flex_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """`torch.nn.attention.flex_attention` (the comparison point the
    reference implementation benchmarks against), with a bottom-right
    causal block mask and native GQA; eager on the CPU, compiled once per
    process on the card."""
    from torch.nn.attention.flex_attention import create_block_mask
    from torch.nn.attention.flex_attention import flex_attention as flex

    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    block_mask = None
    if causal:
        shift = Sk - Sq
        block_mask = create_block_mask(lambda b, h, qi, ki: qi + shift >= ki, None, None, Sq, Sk,
                                       device=q.device)
    fn = _compiled_flex() if q.is_cuda else flex
    o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), block_mask=block_mask,
           scale=_scale(D, softmax_scale), enable_gqa=Hq != Hkv)
    return o.transpose(1, 2)
