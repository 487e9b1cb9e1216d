"""LLaMA-style decoder LM on the port's attention kernels.

Port of `fa2_triton_tpu/models/llama.py`: RMSNorm + RoPE + GQA flash
attention + SwiGLU. The model is an `nn.Module` whose parameters keep the
JAX names and orientation (`wq` is [dim, Hq * hd], applied as `x @ wq`;
norms are fp32), so converting a JAX parameter tree is a copy
(`models/convert.py:llama_from_jax_params`).

Ported: `forward` (differentiable; `cfg.remat` checkpoints each layer),
`loss_fn`, `prefill_forward`, `decode_step` (contiguous cache, stored in
the compute dtype or int8 / fp8) and `paged_decode_step` (page pool and
block tables). Not yet ported: `chunk_prefill_step`, `forward_with_cache`,
and MoE layers (a "router" layer raises).

Layout convention: activations [batch, seq, dim]; attention tensors BSHD.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fa2_triton_tpu_torch.ops import flash_attn_func
from fa2_triton_tpu_torch.ops.decode import decode_attention, paged_decode_attention
from fa2_triton_tpu_torch.ops.quant import qmatmul as _mm
from fa2_triton_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 4
    hidden_dim: int = 5632          # SwiGLU inner dim
    head_dim: Optional[int] = None  # defaults to dim // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16
    # Sliding window: each token attends to at most `sliding_window`
    # previous tokens (-1 = full causal).
    sliding_window: int = -1
    qkv_bias: bool = False
    hidden_act: str = "silu"
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    attn_scale: Optional[float] = None
    alt_window: bool = False
    window_pattern: Optional[Tuple[bool, ...]] = None
    # Llama-3.x RoPE scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = vanilla RoPE.
    rope_factors: Optional[Tuple[float, float, float, float]] = None
    # Training: per-layer gradient checkpointing (torch.utils.checkpoint),
    # so the backward recomputes each layer's forward.
    remat: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    @property
    def scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None else self.hd ** -0.5

    def window_for(self, li: int) -> int:
        """Effective sliding window for layer `li` (-1 = full causal)."""
        if self.sliding_window < 0:
            return -1
        if self.window_pattern is not None:
            return self.sliding_window if self.window_pattern[li] else -1
        if self.alt_window and li % 2 == 1:
            return -1
        return self.sliding_window


def _param(*shape, dtype, device, fill=None):
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class LlamaLayer(nn.Module):
    """One decoder layer's parameters, named as in the JAX layer dict.
    Optional JAX keys (bq/bk/bv, q_norm/k_norm, post_attn_norm/post_mlp_norm)
    are attributes set to None when absent. `device` defaults to the GPU
    (`resolve_device`)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        d, hd, dt = cfg.dim, cfg.hd, cfg.dtype
        f32 = torch.float32
        self.attn_norm = _param(d, dtype=f32, device=device, fill=1.0)
        self.wq = _param(d, cfg.n_heads * hd, dtype=dt, device=device)
        self.wk = _param(d, cfg.n_kv_heads * hd, dtype=dt, device=device)
        self.wv = _param(d, cfg.n_kv_heads * hd, dtype=dt, device=device)
        self.wo = _param(cfg.n_heads * hd, d, dtype=dt, device=device)
        self.mlp_norm = _param(d, dtype=f32, device=device, fill=1.0)
        self.w_gate = _param(d, cfg.hidden_dim, dtype=dt, device=device)
        self.w_up = _param(d, cfg.hidden_dim, dtype=dt, device=device)
        self.w_down = _param(cfg.hidden_dim, d, dtype=dt, device=device)
        if cfg.qkv_bias:
            self.bq = _param(cfg.n_heads * hd, dtype=f32, device=device, fill=0.0)
            self.bk = _param(cfg.n_kv_heads * hd, dtype=f32, device=device, fill=0.0)
            self.bv = _param(cfg.n_kv_heads * hd, dtype=f32, device=device, fill=0.0)
        else:
            self.bq = self.bk = self.bv = None
        self.q_norm = self.k_norm = None
        self.post_attn_norm = self.post_mlp_norm = None


class LlamaModel(nn.Module):
    """Parameters of the decoder LM: embed [V, dim], layers, final_norm,
    lm_head [dim, V] (untied). `model(tokens)` runs `forward`. `device`
    defaults to the GPU (`resolve_device`)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = _param(cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = _param(cfg.dim, dtype=torch.float32, device=device, fill=1.0)
        self.lm_head = _param(cfg.dim, cfg.vocab_size, dtype=cfg.dtype, device=device)

    def forward(self, tokens, positions=None):
        return forward(self, tokens, positions=positions)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: LlamaConfig, device=None) -> LlamaModel:
    """Random model: matmul weights and the embedding N(0, 1/fan_in) (drawn
    in fp32 on the generator's device, then cast), norms 1, biases 0 — the
    JAX `init_params` distribution. Torch and JAX draw different numbers
    from the same seed; parity tests convert a JAX tree instead."""
    device = generator.device if device is None else device
    model = LlamaModel(cfg, device=device)

    def fill(p: torch.Tensor, fan_in: int):
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=device)
        p.copy_(x.div_(math.sqrt(fan_in)))

    for layer in model.layers:
        fill(layer.wq, cfg.dim)
        fill(layer.wk, cfg.dim)
        fill(layer.wv, cfg.dim)
        fill(layer.wo, cfg.n_heads * cfg.hd)
        fill(layer.w_gate, cfg.dim)
        fill(layer.w_up, cfg.dim)
        fill(layer.w_down, cfg.hidden_dim)
    fill(model.embed, cfg.dim)
    fill(model.lm_head, cfg.dim)
    return model


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * weight).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 factors: Optional[Tuple[float, float, float, float]] = None):
    """positions [.., S] int -> cos/sin [.., S, head_dim/2] fp32 (Llama-3.x
    NTK-by-parts scaling when `factors` is set)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                               exponent)
    if factors is not None:
        factor, low_f, high_f, orig_max = factors
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = orig_max / low_f
        high_wl = orig_max / high_f
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wl, inv_freq / factor,
            torch.where(wavelen < high_wl, inv_freq, smoothed))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin broadcastable to [B, S, 1, D/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(layer: LlamaLayer, h: torch.Tensor, cfg: LlamaConfig):
    """Pre-RoPE q/k/v projections, with additive biases and per-head QK
    RMSNorm when the layer carries them."""
    B, S, _ = h.shape
    q = _mm(h, layer.wq)
    k = _mm(h, layer.wk)
    v = _mm(h, layer.wv)
    if layer.bq is not None:
        q = (q.float() + layer.bq).to(q.dtype)
        k = (k.float() + layer.bk).to(k.dtype)
        v = (v.float() + layer.bv).to(v.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if layer.q_norm is not None:
        q = rms_norm(q, layer.q_norm, cfg.norm_eps)
        k = rms_norm(k, layer.k_norm, cfg.norm_eps)
    return q, k, v.reshape(B, S, cfg.n_kv_heads, cfg.hd)


def _attn_out(layer: LlamaLayer, x, attn, cfg: LlamaConfig):
    """Output projection, optional post-norm, residual add."""
    B, S = attn.shape[:2]
    out = _mm(attn.reshape(B, S, cfg.n_heads * cfg.hd), layer.wo)
    if layer.post_attn_norm is not None:
        out = rms_norm(out, layer.post_attn_norm, cfg.norm_eps)
    return x + out


_ACTS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
}


def _mlp_block(layer: LlamaLayer, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    h = rms_norm(x, layer.mlp_norm, cfg.norm_eps)
    gated = _ACTS[cfg.hidden_act](_mm(h, layer.w_gate)) * _mm(h, layer.w_up)
    out = _mm(gated, layer.w_down)
    if layer.post_mlp_norm is not None:
        out = rms_norm(out, layer.post_mlp_norm, cfg.norm_eps)
    return x + out


def _logits(x: torch.Tensor, model: LlamaModel, cfg: LlamaConfig) -> torch.Tensor:
    """LM-head projection (+ final tanh softcap), fp32 out."""
    logits = _mm(x, model.lm_head).float()
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _window_args(cfg: LlamaConfig, li: int):
    w = cfg.window_for(li)
    return (w, 0) if w >= 0 else (-1, -1)


def make_attention_fn(cfg: LlamaConfig, li: int = 0) -> Callable:
    """Config-driven causal attention for layer `li` (window, softcap, scale)."""
    window = _window_args(cfg, li)

    def attn(q, k, v):
        return flash_attn_func(q, k, v, causal=True, softmax_scale=cfg.scale,
                               window_size=window, softcap=cfg.attn_softcap)
    return attn


def attention_block(layer: LlamaLayer, x, cfg: LlamaConfig, cos, sin,
                    attention_fn: Callable) -> torch.Tensor:
    """Pre-norm self-attention sublayer with residual (no cache)."""
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    q, k, v = _qkv(layer, h, cfg)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
    return _attn_out(layer, x, attention_fn(q, k, v), cfg)


def _layer(layer: LlamaLayer, x, cfg: LlamaConfig, cos, sin, attention_fn: Callable):
    return _mlp_block(layer, attention_block(layer, x, cfg, cos, sin, attention_fn), cfg)


def forward(
    model: LlamaModel,
    tokens: torch.Tensor,                 # [B, S] int
    attention_fn: Optional[Callable] = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full causal forward -> logits [B, S, vocab] (fp32), differentiable.

    `attention_fn(q, k, v)` (BSHD) overrides the config-driven per-layer
    attention for every layer. With `cfg.remat` and grad enabled, each layer
    keeps only its input and is recomputed in the backward (the JAX
    `jax.checkpoint` per layer, `fa2_triton_tpu/models/llama.py:343-344`)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed[tokens]
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    for li, layer in enumerate(model.layers):
        fn = attention_fn if attention_fn is not None else make_attention_fn(cfg, li)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer, layer, x, cfg, cos, sin, fn, use_reentrant=False)
        else:
            x = _layer(layer, x, cfg, cos, sin, fn)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(x, model, cfg)


def loss_fn(model: LlamaModel, tokens: torch.Tensor,
            attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy on fp32 logits, mean over positions
    (`fa2_triton_tpu/models/llama.py:loss_fn`)."""
    logits = forward(model, tokens[:, :-1], attention_fn)
    targets = tokens[:, 1:]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def prefill_forward(
    model: LlamaModel,
    tokens: torch.Tensor,       # [B, S_pad] int, right-padded
    true_len: torch.Tensor,     # [B] int
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Prompt prefill: causal self-attention over the padded prompt with a
    padding mask. Returns (logits [B, S_pad, V] fp32, per-layer (k, v) in
    BSHD) for the cache fill."""
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed[tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    mask = positions < true_len.to(tokens.device)[:, None]
    kvs = []
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
        kvs.append((k, v))
        attn = flash_attn_func(
            q, k, v, attention_mask=mask, causal=True, softmax_scale=cfg.scale,
            softcap=cfg.attn_softcap, window_size=_window_args(cfg, li),
        )
        x = _attn_out(layer, x, attn, cfg)
        x = _mlp_block(layer, x, cfg)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(x, model, cfg), kvs


def _decode_layers(model: LlamaModel, tokens: torch.Tensor, lens: torch.Tensor,
                   write_and_attend: Callable) -> torch.Tensor:
    """The layer loop of one batched decode step: `write_and_attend(li, q,
    k, v)` stores the new k/v of layer `li` and returns its attention
    output [B, Hq, D]. Returns logits [B, V]."""
    cfg = model.cfg
    x = model.embed[tokens][:, None, :]        # [B, 1, dim]
    cos, sin = rope_cos_sin(lens[:, None], cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
        attn = write_and_attend(li, q[:, 0].contiguous(), k, v)
        x = _attn_out(layer, x, attn[:, None], cfg)
        x = _mlp_block(layer, x, cfg)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(x[:, 0], model, cfg)


def decode_step(
    model: LlamaModel,
    tokens: torch.Tensor,       # [B] int — one token per slot
    caches,                     # runtime KV cache: list of layer dicts (BHSD)
    lens: torch.Tensor,         # [B] int32 — tokens already in each slot
    kv_cfg,                     # runtime.kv_cache.KVCacheConfig
):
    """One batched decode step over the serving KV cache. Writes each slot's
    new k/v at `lens` IN PLACE (quantized when the cache is; saves a full
    cache copy per layer per step) and attends over lens + 1 rows. Returns
    (logits [B, V], caches)."""
    from fa2_triton_tpu_torch.runtime.kv_cache import write_kv

    cfg = model.cfg
    kv_lens = (lens + 1).to(torch.int32)

    def write_and_attend(li, q, k, v):
        cache = caches[li]
        write_kv(cache, k, v, lens, kv_cfg)
        return decode_attention(
            q, cache["k"], cache["v"], kv_lens, cache.get("k_scale"), cache.get("v_scale"),
            softmax_scale=cfg.scale, window_left=cfg.window_for(li), softcap=cfg.attn_softcap)

    return _decode_layers(model, tokens, lens, write_and_attend), caches


def paged_decode_step(
    model: LlamaModel,
    tokens: torch.Tensor,       # [B] int — one token per slot
    pools,                      # per-layer page-pool dicts (shared pages)
    tables: torch.Tensor,       # [n_slots, max_pages] int32 block tables
    lens: torch.Tensor,         # [B] int32 — tokens already in each slot
    pcfg,                       # runtime.paged_cache.PagedCacheConfig
):
    """One batched decode step over the paged KV cache
    (`fa2_triton_tpu/models/llama.py:paged_decode_step`): scatters each
    slot's new k/v through its table row at `lens`, IN PLACE, and attends
    over lens + 1 rows. Returns (logits [B, V], pools)."""
    from fa2_triton_tpu_torch.runtime.paged_cache import write_tokens_paged

    cfg = model.cfg
    kv_lens = (lens + 1).to(torch.int32)

    def write_and_attend(li, q, k, v):
        pool = pools[li]
        write_tokens_paged(pool, tables, k, v, lens, pcfg)
        return paged_decode_attention(
            q, pool["k"], pool["v"], tables, kv_lens, pool.get("k_scale"), pool.get("v_scale"),
            softmax_scale=cfg.scale, window_left=cfg.window_for(li), softcap=cfg.attn_softcap)

    return _decode_layers(model, tokens, lens, write_and_attend), pools
