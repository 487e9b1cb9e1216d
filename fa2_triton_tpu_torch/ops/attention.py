"""Public flash-attention API: `flash_attn_func`, differentiable, and the
KV-cache entry point `flash_attn_with_kv_cache` (inference only).

Port of `fa2_triton_tpu/ops/attention.py:flash_attn_func`, BSHD in and out.
The TPU layout rules of the JAX version (the 128-lane head-dim pad, padding
sequences to tuned blocks) do not carry over: the CUDA kernels mask their
own ragged edges, so q/k/v reach them as transposed views, uncopied. The
blocks JAX pads to still decide the causal route (`block_sizes`, else
`ops/tuning.py:choose_block_sizes`). fp16 follows JAX's contract
(`fa2_triton_tpu/ops/attention.py:182-196`): fp16 inputs compute in fp32
by default (the FMA kernels, at fp32 speed) or in bf16 if asked
(`fp16_compute_dtype=torch.bfloat16`, the tensor-core kernels), and the
output comes back in fp16. The kernels' fp16 instantiations stay reachable
through `ops/flash_fwd.flash_attn_forward` / `ops/flash_bwd.
flash_attn_backward`.
A head dim the kernels are not built for (any D <= 512 but 64, 128, 256,
384, 512, and past 512 any D that is not a multiple of 128) is zero-padded
to the next one they are, which is exact: the scale comes from the true D,
zero columns add nothing to q.k, and the padded output columns are sliced
off (their gradients with them). Past 256 that is JAX's round-up to 128
lanes (`fa2_triton_tpu/ops/attention.py`).

`_AttnCore` is the counterpart of the JAX `jax.custom_vjp` core
(`fa2_triton_tpu/ops/attention.py:57-116`): the forward saves
(q, k, v, bias, o, lse) and the backward recomputes attention from the
base-2 LSE through `ops/flash_bwd.py`, taking both cotangents (do, dlse) and
returning a real dbias when the bias requires grad. CPU tensors run the
plain twins of the kernels on both passes; CUDA tensors run the kernels.
The forward takes `flash_fwd.flash_attn_forward`'s causal routing (the
split or strip schedule for long causal calls without a mask, as JAX
routes them), and the backward `flash_bwd.flash_attn_backward`'s (the
tri-square for short causal calls whose GQA group fits JAX's budget, the
work list for long MHA ones), both on the same static shift.

Dropout is the JAX package's counter-hash stream (`utils/rng.py`), seeded
by the seed contract of JAX `attention.py:240-256`: with `dropout_p > 0`,
exactly one of `dropout_seed` (an int32) or `dropout_rng` (a CPU
`torch.Generator`, from which one seed is drawn without touching the
device) must be given. `_AttnCore` keeps the seed as a host int in `ctx`:
the backward regenerates the forward's mask and never draws again.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fa2_triton_tpu_torch.ops.flash_bwd import flash_attn_backward
from fa2_triton_tpu_torch.ops.flash_fwd import HEAD_DIMS, check_ported, flash_attn_forward
from fa2_triton_tpu_torch.ops.tuning import BlockSizes
from fa2_triton_tpu_torch.utils import default_softmax_scale

_INT32_MAX = 2**31 - 1


def resolve_dropout_seed(dropout_p: float, dropout_seed: Optional[int],
                         dropout_rng: Optional[torch.Generator]) -> int:
    """The seed contract of the dropout entry points: `dropout_p` in [0, 1);
    with `dropout_p > 0` exactly one of `dropout_seed` (an int32; negative
    seeds are legal) or `dropout_rng` (a CPU torch.Generator, from which a
    seed in [0, 2**31 - 1) is drawn, as JAX draws one from its key). Returns
    the seed (0 without dropout)."""
    if not 0.0 <= dropout_p < 1.0:
        # JAX divides by 1 - p and returns inf / NaN at p = 1 (ROADMAP.md queue C).
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_seed is not None and not -2**31 <= int(dropout_seed) <= _INT32_MAX:
        raise ValueError(f"dropout_seed must be an int32, got {dropout_seed}")
    if dropout_p == 0.0:
        return int(dropout_seed) if dropout_seed is not None else 0
    if (dropout_seed is None) == (dropout_rng is None):
        raise ValueError(
            "dropout_p > 0 requires dropout_seed or dropout_rng (exactly one): a per-call seed "
            "cannot be drawn silently, and a fixed default would reuse one dropout mask across "
            "every layer and step")
    if dropout_seed is not None:
        return int(dropout_seed)
    if not isinstance(dropout_rng, torch.Generator) or dropout_rng.device.type != "cpu":
        raise ValueError("dropout_rng must be a CPU torch.Generator")
    return int(torch.randint(0, _INT32_MAX, (), generator=dropout_rng))


def kernel_head_dim(D: int) -> int:
    """The head dim the kernels compute a head dim D at, on any device: the
    first of HEAD_DIMS >= D, past them the next multiple of 128 (JAX's
    `head_dim_padded`: 513 -> 640, 1000 -> 1024). The serving caches are
    allocated this wide."""
    return next((d for d in HEAD_DIMS if d >= D), -(-D // 128) * 128)


def pad_head_dim(D: int, device: torch.device, family: Optional[str] = None) -> int:
    """The head dim the kernels compute D at (`kernel_head_dim`). The dense
    forward, the dq + dk/dv pair and decode take every such width; `family`
    names a kernel family built only up to MAX_HEAD_DIM (the packed
    kernels), whose CUDA tensors raise ValueError past it
    (`flash_fwd.check_ported`). CPU tensors take any D."""
    Dp = kernel_head_dim(D)
    if family is not None and device.type == "cuda":
        check_ported(D, family)
    return Dp


def fp16_compute(dtype: torch.dtype, fp16_compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype the kernels compute in for inputs of `dtype`: JAX's fp16
    rule (fp32 by default, bf16 if asked; any other choice raises
    ValueError), every other dtype itself."""
    if dtype != torch.float16:
        return dtype
    cd = torch.float32 if fp16_compute_dtype is None else fp16_compute_dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fp16_compute_dtype must be torch.float32 (precise) or "
                         f"torch.bfloat16 (fast), got {fp16_compute_dtype}")
    return cd


def pad_last(x: torch.Tensor, Dp: int) -> torch.Tensor:
    """x zero-padded on its last dim to Dp (x itself when it is Dp wide)."""
    return x if x.shape[-1] == Dp else F.pad(x, (0, Dp - x.shape[-1]))


class _AttnCore(torch.autograd.Function):
    """o, lse = attention(q, k, v, bias) on BHSD views; lens and the
    static config are not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, bias, lens, causal, scale, window, softcap, dropout_p, seed, varlen,
                blocks):
        cfg = dict(causal=causal, softmax_scale=scale, window=window, softcap=softcap,
                   dropout_p=dropout_p, dropout_seed=seed, block_sizes=blocks)
        # JAX attention.py:258-271: the shift is static (Sk - Sq, or 0 under
        # a shared padding mask), so the causal schedules may route.
        o, lse = flash_attn_forward(q, k, v, lens, 0, 0, bias, static_skip=True, varlen=varlen,
                                    **cfg)
        ctx.save_for_backward(q, k, v, bias, o, lse, lens)
        ctx.cfg = cfg
        ctx.varlen = varlen
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse, lens = ctx.saved_tensors
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        # JAX attention.py:88-104: the backward routes on the same static
        # shift (the causal backward schedules).
        grads = flash_attn_backward(q, k, v, do, o, lse, lens, 0, 0, bias, dlse=dlse,
                                    compute_dbias=want_dbias, static_skip=True,
                                    varlen=ctx.varlen, **ctx.cfg)
        dbias = grads[3] if want_dbias else None
        return (grads[0], grads[1], grads[2], dbias) + (None,) * 9


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
    block_sizes: Optional[BlockSizes] = None,
    return_lse: bool = False,
    dropout_rng: Optional[torch.Generator] = None,
    fp16_compute_dtype: Optional[torch.dtype] = None,
):
    """FlashAttention-2, differentiable through `_AttnCore`.

    Args:
        q: [batch, seqlen_q, num_heads_q, head_dim].
        k, v: [batch, seqlen_k, num_heads_kv, head_dim]; num_heads_q must be
            a multiple of num_heads_kv (GQA/MQA). Any head_dim
            (zero-padded to 64 / 128 / 256 / 384 / 512, past 512 to a
            multiple of 128, for the kernels; a bias gradient past 512
            raises, ROADMAP.md queue A item 1(c)).
        attention_mask: optional bool [batch, seqlen_q] right-padding mask
            (True = valid). Requires seqlen_q == seqlen_k; applied to both
            queries and keys.
        attention_bias: optional additive bias broadcastable to
            [batch, num_heads_q, seqlen_q, seqlen_k] (indexed by q head);
            it gets a gradient when it requires one.
        dropout_p: attention dropout probability, in [0, 1): counter-hash
            dropout (`utils/rng.py`), bit for bit the JAX package's mask.
        dropout_seed: int32 seed of the dropout stream. With dropout_p > 0
            exactly one of dropout_seed / dropout_rng must be given.
        causal: bottom-right-aligned causal masking.
        softmax_scale: defaults to 1/sqrt(head_dim).
        window_size: (left, right) sliding window, -1 = infinite.
        softcap: if > 0, scores are softcap * tanh(scores / softcap).
        block_sizes: JAX's block override (`ops/tuning.py:BlockSizes`). The
            CUDA tiles are compile-time, so on the card it decides only the
            padded shape the causal route is chosen at, as JAX's does.
        return_lse: also return the logsumexp [batch, num_heads_q, seqlen_q]
            in log-base-2 units, fp32.
        dropout_rng: alternatively, a CPU torch.Generator from which the
            seed is drawn (no device sync).
        fp16_compute_dtype: for float16 inputs only, the dtype the kernels
            compute in: torch.float32 by default (precise; the FMA kernels,
            at fp32 speed) or torch.bfloat16 (the tensor-core kernels, at
            bf16 precision). An fp16 bias is widened to fp32; the output
            comes back in fp16. bf16 inputs are the fast path.

    Returns:
        output [batch, seqlen_q, num_heads_q, head_dim] (and lse if requested),
        differentiable in q, k, v, the bias and the lse.
    """
    seed = resolve_dropout_seed(dropout_p, dropout_seed, dropout_rng)
    out_dtype = q.dtype
    cd = fp16_compute(q.dtype, fp16_compute_dtype)
    if cd != q.dtype:
        q, k, v = (x.to(cd) for x in (q, k, v))
        if attention_bias is not None and attention_bias.dtype == torch.float16:
            attention_bias = attention_bias.float()
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
    Dp = pad_head_dim(D, q.device)
    o, lse = _AttnCore.apply(
        *(pad_last(x, Dp).transpose(1, 2) for x in (q, k, v)), bias, lens,
        causal, scale, tuple(window_size), float(softcap), float(dropout_p), seed,
        attention_mask is not None, block_sizes)
    out = o.transpose(1, 2)[..., :D].to(out_dtype)
    if return_lse:
        return out, lse
    return out


def flash_attn_with_kv_cache(
    q: torch.Tensor,          # [B, S_step, Hq, D] — the step's queries
    k_cache: torch.Tensor,    # [B, Hkv, S_max, D] — the cache, the step's rows written
    v_cache: torch.Tensor,
    kv_len: int,              # host int: valid rows (cached + this step's)
    softmax_scale: Optional[float] = None,
    block_q: int = 128,
    block_kv: int = 512,
    window_left: int = -1,    # sliding-window prefix (-1: full causal)
    softcap: float = 0.0,
) -> torch.Tensor:
    """Attention of a prefill or decode step over a KV cache (port of
    `fa2_triton_tpu/ops/attention.py:flash_attn_with_kv_cache`).

    Query row i sits at global position kv_len - S_step + i and attends
    causally to the cache rows < kv_len. The caches are BHSD, the port's
    cache layout (`runtime/kv_cache.py`; JAX's are BSHD), and only their
    first kv_len rows are handed on, as a view: one `flash_fwd` call (B1 on
    CUDA tensors, its plain twin on CPU ones) with lens (kv_len, kv_len),
    q_off kv_len - S_step, the queries as a transposed view. `kv_len` is a
    host int, so a step reads no device value. `block_q` / `block_kv` are
    JAX's TPU tiles (positive, else ValueError); the CUDA tiles are
    compile-time, so, as in JAX, the result does not depend on them.
    Returns [B, S_step, Hq, D] in q's dtype."""
    if isinstance(kv_len, torch.Tensor):
        raise TypeError("kv_len is a host int: a tensor would be read from the device per call")
    if block_q <= 0 or block_kv <= 0:
        raise ValueError(f"block_q / block_kv must be positive, got {block_q} / {block_kv}")
    B, S, Hq, D = q.shape
    kv_len = int(kv_len)
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be [B, Hkv, S_max, D] for q {tuple(q.shape)}, got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if not 0 < S <= kv_len <= k_cache.shape[2]:
        raise ValueError(f"need 0 < S_step {S} <= kv_len {kv_len} <= S_max {k_cache.shape[2]}")
    scale = float(softmax_scale) if softmax_scale is not None else default_softmax_scale(D)
    lens = torch.full((B, 2), kv_len, dtype=torch.int32, device=q.device)
    Dp = pad_head_dim(D, q.device)
    o, _ = flash_attn_forward(
        pad_last(q, Dp).transpose(1, 2), pad_last(k_cache[:, :, :kv_len], Dp),
        pad_last(v_cache[:, :, :kv_len], Dp), lens, kv_len - S, causal=True,
        softmax_scale=scale, window=(window_left, 0) if window_left >= 0 else (-1, -1),
        softcap=float(softcap), seqlen_q_real=S, seqlen_k_real=kv_len, static_skip=False,
        varlen=True)
    return o.transpose(1, 2)[..., :D]
