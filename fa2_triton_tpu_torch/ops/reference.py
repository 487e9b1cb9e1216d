"""Plain PyTorch attention oracle (port of `fa2_triton_tpu.ops.reference`).

GQA via head repetition, pre-softmax scaling, tanh softcapping, key-padding
masks, sliding-window masks with bottom-right-aligned causal offsets,
additive broadcastable bias, externally supplied dropout masks, zero-fill of
fully-masked rows, the `upcast` / `reorder_ops` knobs of the relative
tolerance harness, and the base-2 logsumexp. Plain tensor ops on any device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from fa2_triton_tpu_torch.utils import LOG2E


def construct_local_mask(
    seqlen_q: int,
    seqlen_k: int,
    window_size: Tuple[int, int] = (-1, -1),
    query_padding_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Boolean mask (True = MASKED OUT) broadcastable to [B, 1, Sq, Sk].

    Bottom-right aligned: the causal/window diagonal runs through the last
    valid key of each sequence, using per-batch actual lengths when padding
    masks are given. -1 means infinite on that side, including when only
    one side is set (the one-sided window fix of the JAX oracle).
    """
    if device is None:
        ref = query_padding_mask if query_padding_mask is not None else key_padding_mask
        device = ref.device if ref is not None else None
    row_idx = torch.arange(seqlen_q, dtype=torch.int64, device=device).reshape(seqlen_q, 1)
    col_idx = torch.arange(seqlen_k, dtype=torch.int64, device=device)
    if key_padding_mask is None:
        sk = seqlen_k
    else:
        sk = key_padding_mask.sum(-1).to(torch.int64).reshape(-1, 1, 1, 1)
    if query_padding_mask is None:
        sq = seqlen_q
    else:
        sq = query_padding_mask.sum(-1).to(torch.int64).reshape(-1, 1, 1, 1)
    if window_size[0] < 0 and window_size[1] < 0:
        return torch.zeros((seqlen_q, seqlen_k), dtype=torch.bool, device=device)
    if window_size[0] < 0:
        return col_idx > row_idx + sk - sq + window_size[1]
    if window_size[1] < 0:
        return col_idx < row_idx + sk - sq - window_size[0]
    upper = torch.minimum(row_idx + sk - sq + window_size[1], torch.as_tensor(sk, device=device))
    return torch.logical_or(col_idx > upper, col_idx < row_idx + sk - sq - window_size[0])


def flash_attn_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    query_padding_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
    reorder_ops: bool = False,
    return_lse: bool = False,
):
    """Ground-truth attention.

    Args:
        q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] with Hq % Hkv == 0.
        query_padding_mask / key_padding_mask: bool [B, Sq] / [B, Sk].
        attn_bias: additive, broadcastable to [B, Hq, Sq, Sk].
        dropout_mask: bool keep-mask [B, Hq, Sq, Sk] (True = keep).
        causal: bottom-right aligned causal masking.
        window_size: (left, right) sliding window; -1 = infinite.
        softcap: if > 0, scores = softcap * tanh(scores / softcap).
        upcast: compute in fp32 and cast back at the end.
        reorder_ops: scale K instead of Q (error-yardstick variant).
        return_lse: also return the base-2 logsumexp [B, Hq, Sq].

    Returns:
        output [B, Sq, Hq, D], and optionally lse [B, Hq, Sq] (fp32 when
        upcast).
    """
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
        if attn_bias is not None:
            attn_bias = attn_bias.float()
    seqlen_q, seqlen_k = q.shape[1], k.shape[1]
    repeats = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(repeats, dim=2)
    v = v.repeat_interleave(repeats, dim=2)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if not reorder_ops:
        scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    else:
        scores = torch.einsum("bthd,bshd->bhts", q, k * scale)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if key_padding_mask is not None:
        kpm = ~key_padding_mask.bool()
        scores = scores.masked_fill(kpm.reshape(kpm.shape[0], 1, 1, seqlen_k), float("-inf"))
    local_mask = None
    if window_size[0] >= 0 or window_size[1] >= 0:
        local_mask = construct_local_mask(
            seqlen_q, seqlen_k, window_size, query_padding_mask, key_padding_mask,
            device=q.device,
        )
        scores = scores.masked_fill(local_mask, float("-inf"))
    if attn_bias is not None:
        scores = scores + attn_bias

    row_max = scores.amax(dim=-1, keepdim=True)
    row_max_safe = torch.where(torch.isinf(row_max), torch.zeros_like(row_max), row_max)
    unnorm = torch.exp(scores - row_max_safe)
    unnorm = torch.where(torch.isinf(scores) & (scores < 0), torch.zeros_like(unnorm), unnorm)
    denom = unnorm.sum(dim=-1, keepdim=True)
    attention = unnorm / torch.clamp(denom, min=torch.finfo(unnorm.dtype).tiny)
    lse = (row_max_safe + torch.log(torch.clamp(denom, min=0.0)))[..., 0] * LOG2E

    attention = attention.to(v.dtype)
    # Zero fully-masked rows so they produce 0 output, not NaN.
    if local_mask is not None:
        attention = attention.masked_fill(local_mask.all(dim=-1, keepdim=True), 0.0)
    if query_padding_mask is not None:
        qmask = ~query_padding_mask.bool()
        attention = attention.masked_fill(qmask.reshape(q.shape[0], 1, seqlen_q, 1), 0.0)
    dropout_scaling = 1.0 / (1.0 - dropout_p)
    if dropout_mask is not None:
        attention_drop = attention.masked_fill(~dropout_mask.bool(), 0.0)
    else:
        attention_drop = attention
    output = torch.einsum("bhts,bshd->bthd", attention_drop, v * dropout_scaling)
    if query_padding_mask is not None:
        qmask_o = ~query_padding_mask.bool()
        output = output.masked_fill(qmask_o.reshape(q.shape[0], seqlen_q, 1, 1), 0.0)
    output = output.to(dtype_og)
    if return_lse:
        return output, lse
    return output
