"""Public flash-attention API: `flash_attn_func` (forward only).

Port of `fa2_triton_tpu/ops/attention.py:flash_attn_func`, BSHD in and out.
The TPU layout rules of the JAX version (the 128-lane head-dim pad, padding
sequences to tuned blocks, the fp16 -> fp32 upcast because Mosaic has no
fp16) do not carry over: the CUDA kernel masks its own ragged edges and
computes fp16/bf16 natively, so q/k/v reach it as transposed views, uncopied.

Not ported yet (each raises NotImplementedError, see ROADMAP.md queue A):
attention bias, dropout, and gradients through CUDA tensors (the backward
kernels B2-B4). On the CPU the plain path is differentiable by autograd.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops.flash_fwd import flash_attn_forward
from fa2_triton_tpu_torch.utils import default_softmax_scale


def flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    attention_bias: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    dropout_seed: Optional[int] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    return_lse: bool = False,
):
    """FlashAttention-2 forward.

    Args:
        q: [batch, seqlen_q, num_heads_q, head_dim].
        k, v: [batch, seqlen_k, num_heads_kv, head_dim]; num_heads_q must be
            a multiple of num_heads_kv (GQA/MQA).
        attention_mask: optional bool [batch, seqlen_q] right-padding mask
            (True = valid). Requires seqlen_q == seqlen_k; applied to both
            queries and keys.
        attention_bias, dropout_p, dropout_seed: not ported yet; a bias or
            dropout_p > 0 raises NotImplementedError.
        causal: bottom-right-aligned causal masking.
        softmax_scale: defaults to 1/sqrt(head_dim).
        window_size: (left, right) sliding window, -1 = infinite.
        softcap: if > 0, scores are softcap * tanh(scores / softcap).
        return_lse: also return the logsumexp [batch, num_heads_q, seqlen_q]
            in log-base-2 units, fp32.

    Returns:
        output [batch, seqlen_q, num_heads_q, head_dim] (and lse if requested).
    """
    if attention_bias is not None:
        raise NotImplementedError(
            "attention_bias is not ported yet (forward bias + dbias kernels, "
            "ROADMAP.md queue A: training slice)")
    if dropout_p > 0.0:
        raise NotImplementedError(
            "dropout is not ported yet (counter-hash dropout, ROADMAP.md queue "
            "A: training slice)")
    if q.device.type == "cuda" and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "gradients through the CUDA kernel need the backward kernels "
            "(B2-B4, ROADMAP.md queue A: training slice); run under "
            "torch.no_grad() / torch.inference_mode()")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if D != Dk or v.shape != k.shape or Bk != B:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % Hkv != 0:
        raise ValueError("num_heads_q must be a multiple of num_heads_kv")
    scale = float(softmax_scale) if softmax_scale is not None else default_softmax_scale(D)
    if attention_mask is not None:
        if Sq != Sk or tuple(attention_mask.shape) != (B, Sq):
            raise ValueError("attention_mask must be [batch, seqlen] with seqlen_q == seqlen_k")
        qlen = attention_mask.to(torch.int32).sum(-1, dtype=torch.int32)
        lens = torch.stack([qlen, qlen], dim=-1)
    else:
        lens = torch.tensor([[Sq, Sk]], dtype=torch.int32).expand(B, 2)
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    o, lse = flash_attn_forward(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lens, 0, 0,
        causal=causal, softmax_scale=scale, window=tuple(window_size),
        softcap=float(softcap),
    )
    out = o.transpose(1, 2)
    if return_lse:
        return out, lse
    return out
