"""Public flash-attention API: `flash_attn_func`, differentiable.

Port of `fa2_triton_tpu/ops/attention.py:flash_attn_func`, BSHD in and out.
The TPU layout rules of the JAX version (the 128-lane head-dim pad, padding
sequences to tuned blocks, the fp16 -> fp32 upcast because Mosaic has no
fp16) do not carry over: the CUDA kernels mask their own ragged edges and
compute fp16/bf16 natively, so q/k/v reach them as transposed views, uncopied.

`_AttnCore` is the counterpart of the JAX `jax.custom_vjp` core
(`fa2_triton_tpu/ops/attention.py:57-116`): the forward saves
(q, k, v, bias, o, lse) and the backward recomputes attention from the
base-2 LSE through `ops/flash_bwd.py`, taking both cotangents (do, dlse) and
returning a real dbias when the bias requires grad. CPU tensors run the
plain twins of the kernels on both passes; CUDA tensors run the kernels.

Not ported yet: dropout (counter-hash dropout, `utils/rng.py`; ROADMAP.md
queue A.6); `dropout_p > 0` raises NotImplementedError.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops.flash_bwd import flash_attn_backward
from fa2_triton_tpu_torch.ops.flash_fwd import flash_attn_forward
from fa2_triton_tpu_torch.utils import default_softmax_scale


class _AttnCore(torch.autograd.Function):
    """o, lse = attention(q, k, v, bias) on BHSD views; lens and the
    static config are not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, bias, lens, causal, scale, window, softcap):
        o, lse = flash_attn_forward(q, k, v, lens, 0, 0, bias, causal=causal,
                                    softmax_scale=scale, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, bias, o, lse, lens)
        ctx.cfg = dict(causal=causal, softmax_scale=scale, window=window, softcap=softcap)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse, lens = ctx.saved_tensors
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        grads = flash_attn_backward(q, k, v, do, o, lse, lens, 0, 0, bias, dlse=dlse,
                                    compute_dbias=want_dbias, **ctx.cfg)
        dbias = grads[3] if want_dbias else None
        return grads[0], grads[1], grads[2], dbias, None, None, None, None, None


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
    """FlashAttention-2, differentiable through `_AttnCore`.

    Args:
        q: [batch, seqlen_q, num_heads_q, head_dim].
        k, v: [batch, seqlen_k, num_heads_kv, head_dim]; num_heads_q must be
            a multiple of num_heads_kv (GQA/MQA).
        attention_mask: optional bool [batch, seqlen_q] right-padding mask
            (True = valid). Requires seqlen_q == seqlen_k; applied to both
            queries and keys.
        attention_bias: optional additive bias broadcastable to
            [batch, num_heads_q, seqlen_q, seqlen_k] (indexed by q head);
            it gets a gradient when it requires one.
        dropout_p, dropout_seed: not ported yet; dropout_p > 0 raises
            NotImplementedError.
        causal: bottom-right-aligned causal masking.
        softmax_scale: defaults to 1/sqrt(head_dim).
        window_size: (left, right) sliding window, -1 = infinite.
        softcap: if > 0, scores are softcap * tanh(scores / softcap).
        return_lse: also return the logsumexp [batch, num_heads_q, seqlen_q]
            in log-base-2 units, fp32.

    Returns:
        output [batch, seqlen_q, num_heads_q, head_dim] (and lse if requested),
        differentiable in q, k, v, the bias and the lse.
    """
    if dropout_p > 0.0:
        raise NotImplementedError(
            "dropout is not ported yet (counter-hash dropout and utils/rng.py, "
            "ROADMAP.md queue A.6)")
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
    bias = None
    if attention_bias is not None:
        bias = attention_bias.reshape((1,) * (4 - attention_bias.dim()) + tuple(attention_bias.shape))
        if bias.dim() != 4 or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, Hq):
            raise ValueError(f"attention_bias {tuple(attention_bias.shape)} does not broadcast "
                             f"to [{B}, {Hq}, {Sq}, {Sk}]")
        # Seq dims broadcast as a view; autograd of expand sums dbias back.
        bias = bias.expand(bias.shape[0], bias.shape[1], Sq, Sk)
    o, lse = _AttnCore.apply(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias, lens,
        causal, scale, tuple(window_size), float(softcap))
    out = o.transpose(1, 2)
    if return_lse:
        return out, lse
    return out
