"""LLaMA-style decoder LM on the port's attention kernels.

Port of `fa2_triton_tpu/models/llama.py`: RMSNorm + RoPE + GQA flash
attention + SwiGLU. The model is an `nn.Module` whose parameters keep the
JAX names and orientation (`wq` is [dim, Hq * hd], applied as `x @ wq`;
norms are fp32), so converting a JAX parameter tree is a copy
(`models/convert.py:llama_from_jax_params`).

Ported: `forward` (differentiable; `cfg.remat` checkpoints each layer),
`loss_fn` (both over a TP group too, as JAX trains under `param_pspecs`:
Megatron's f on the normed input of every column-parallel product, g on
every row-parallel one, and the vocab-parallel logits gathered before the
loss; and over FSDP's gathered weights through `gather_fn`),
`prefill_forward`, `decode_step` (contiguous cache, stored in the compute
dtype or int8 / fp8), `paged_decode_step` (page pool and block
tables), `chunk_prefill_step` (one prompt chunk against a slot's cached
prefix; `paged_chunk_prefill_step` is its page-pool form) and the cached
forward of speculative decoding (`forward_with_cache` over `init_kv_cache`'s
BHSD caches through `make_cached_attention_fn`, that is
`ops/attention.py:flash_attn_with_kv_cache`). The serving paths take a
`tp_group` (JAX's `psum_axis`): the model is then one rank's head shard
(`parallel/mesh.py:shard_params`, local head counts in its config), and
the row-parallel products of `wo` and `w_down` are summed over the group
(`parallel/collectives.py:all_reduce`) before any post-norm; MoE experts
stay replicated and take no sum (JAX l.244-250). A Mixtral-style MoE layer
(`models/moe.py`: an fp32 `router` and experts `we_gate` / `we_up` /
`we_down` in place of the dense MLP) takes every one of these paths through
`_mlp_block`'s dense all-experts block, as in JAX. `quantize_model_params`
makes a weight-only int8 / fp8 model that every path and the Engine take.

Layout convention: activations [batch, seq, dim]; attention tensors BSHD.
"""
from __future__ import annotations

import copy
import inspect
import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fa2_triton_tpu_torch.ops import flash_attn_func, flash_fwd
from fa2_triton_tpu_torch.ops.attention import flash_attn_with_kv_cache, pad_head_dim, pad_last
from fa2_triton_tpu_torch.ops.decode import decode_attention, paged_decode_attention
from fa2_triton_tpu_torch.ops.quant import QuantizedWeight, qmatmul as _mm, quantize_weight
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
    are attributes set to None when absent. A config with `n_experts`
    (`models/moe.py:MoEConfig`) gives an MoE layer: `router` [dim, E] fp32
    and `we_gate` / `we_up` [E, dim, hidden], `we_down` [E, hidden, dim] in
    place of `w_gate` / `w_up` / `w_down` (then None); a dense layer's
    `router` is None. `device` defaults to the GPU (`resolve_device`)."""

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
        n_experts, h = getattr(cfg, "n_experts", 0), cfg.hidden_dim
        if n_experts:
            # The router stays fp32: a bf16 near tie would flip the choice.
            self.router = _param(d, n_experts, dtype=f32, device=device)
            self.we_gate = _param(n_experts, d, h, dtype=dt, device=device)
            self.we_up = _param(n_experts, d, h, dtype=dt, device=device)
            self.we_down = _param(n_experts, h, d, dtype=dt, device=device)
            self.w_gate = self.w_up = self.w_down = None
        else:
            self.w_gate = _param(d, h, dtype=dt, device=device)
            self.w_up = _param(d, h, dtype=dt, device=device)
            self.w_down = _param(h, d, dtype=dt, device=device)
            self.router = None
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
    """Random model: matmul weights (the MoE router and experts too) and the
    embedding N(0, 1/fan_in) (drawn in fp32 on the generator's device, then
    cast), norms 1, biases 0 — the JAX `init_params` distribution. Torch and
    JAX draw different numbers from the same seed; parity tests convert a
    JAX tree instead."""
    device = generator.device if device is None else device
    model = LlamaModel(cfg, device=device)

    def fill(p: torch.Tensor, fan_in: int):
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=device)
        p.copy_(x.div_(math.sqrt(fan_in)))

    fan_in = {"wo": cfg.n_heads * cfg.hd, "w_down": cfg.hidden_dim, "we_down": cfg.hidden_dim}
    for layer in model.layers:
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "router", "we_gate", "we_up", "we_down"):
            if getattr(layer, name, None) is not None:
                fill(getattr(layer, name), fan_in.get(name, cfg.dim))
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


def _copy(x: torch.Tensor, tp_group) -> torch.Tensor:
    """A replicated input of column-parallel products (Megatron's f: the
    identity forward, its cotangent summed over the TP group backward); x
    itself without a group."""
    if tp_group is None:
        return x
    from fa2_triton_tpu_torch.parallel.collectives import copy_to_group

    return copy_to_group(x, tp_group)


def _reduce(x: torch.Tensor, tp_group) -> torch.Tensor:
    """A row-parallel partial product summed over the TP group (JAX
    `_psum`; Megatron: wo / w_down shard their input dim); x itself
    without a group."""
    if tp_group is None:
        return x
    from fa2_triton_tpu_torch.parallel.collectives import all_reduce

    return all_reduce(x, tp_group)


def _attn_out(layer: LlamaLayer, x, attn, cfg: LlamaConfig, tp_group=None):
    """Output projection (summed over `tp_group`), optional post-norm,
    residual add."""
    B, S = attn.shape[:2]
    out = _reduce(_mm(attn.reshape(B, S, cfg.n_heads * cfg.hd), layer.wo), tp_group)
    if layer.post_attn_norm is not None:
        out = rms_norm(out, layer.post_attn_norm, cfg.norm_eps)
    return x + out


_ACTS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
}


def _mlp_block(layer: LlamaLayer, x: torch.Tensor, cfg: LlamaConfig,
               tp_group=None) -> torch.Tensor:
    if layer.router is not None:
        # MoE layer: every path here (forward, prefill, decode, chunks, the
        # cached forward, the Engine) takes the dense all-experts block, as
        # JAX does: capacity routing would make a token's output depend on
        # what else shares its batch.
        from fa2_triton_tpu_torch.models.moe import moe_mlp_dense

        return moe_mlp_dense(layer, x, cfg)[0]
    h = _copy(rms_norm(x, layer.mlp_norm, cfg.norm_eps), tp_group)
    gated = _ACTS[cfg.hidden_act](_mm(h, layer.w_gate)) * _mm(h, layer.w_up)
    out = _reduce(_mm(gated, layer.w_down), tp_group)
    if layer.post_mlp_norm is not None:
        out = rms_norm(out, layer.post_mlp_norm, cfg.norm_eps)
    return x + out


def _logits(x: torch.Tensor, model: LlamaModel, cfg: LlamaConfig) -> torch.Tensor:
    """LM-head projection (+ final tanh softcap), fp32 out."""
    logits = _mm(x, model.lm_head).float()
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _head_logits(x: torch.Tensor, model: LlamaModel, cfg: LlamaConfig, tp_group=None):
    """`_logits` of the training forward: with a vocab-parallel lm_head
    (`parallel/mesh.py:param_pspecs` cuts its vocab over the TP group) each
    rank projects f(x) onto its vocab piece, and the pieces are gathered
    along the vocab, so every rank holds the whole logits (the backward
    keeps each rank's piece of their cotangent). A replicated head
    (`moe_param_pspecs`) takes no collective."""
    if tp_group is None or model.lm_head.shape[-1] == cfg.vocab_size:
        return _logits(x, model, cfg)
    from fa2_triton_tpu_torch.parallel.collectives import gather

    logits = _logits(_copy(x, tp_group), model, cfg)
    return gather(logits, (None,) * (logits.dim() - 1) + ("model",), {"model": tp_group})


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
                    attention_fn: Callable, tp_group=None) -> torch.Tensor:
    """Pre-norm self-attention sublayer with residual (no cache); over a TP
    group the layer holds its heads and `cfg` their local counts."""
    h = _copy(rms_norm(x, layer.attn_norm, cfg.norm_eps), tp_group)
    q, k, v = _qkv(layer, h, cfg)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
    return _attn_out(layer, x, attention_fn(q, k, v), cfg, tp_group)


def _layer(layer: LlamaLayer, x, cfg: LlamaConfig, cos, sin, attention_fn: Callable,
           tp_group=None, gather_fn=None):
    if gather_fn is not None:
        layer = gather_fn(layer)
    x = attention_block(layer, x, cfg, cos, sin, attention_fn, tp_group)
    return _mlp_block(layer, x, cfg, tp_group)


def forward(
    model: LlamaModel,
    tokens: torch.Tensor,                 # [B, S] int
    attention_fn: Optional[Callable] = None,
    positions: Optional[torch.Tensor] = None,
    tp_group=None,
    gather_fn: Optional[Callable[[nn.Module], nn.Module]] = None,
) -> torch.Tensor:
    """Full causal forward -> logits [B, S, vocab] (fp32), differentiable.

    `attention_fn(q, k, v)` (BSHD) overrides the config-driven per-layer
    attention for every layer. With `cfg.remat` and grad enabled, each layer
    keeps only its input and is recomputed in the backward (the JAX
    `jax.checkpoint` per layer, `fa2_triton_tpu/models/llama.py:343-344`).

    With `tp_group` the model is one TP rank's shard (`parallel/mesh.py:
    shard_params` under `param_pspecs`, the local head counts in its
    config): each column-parallel product takes f of its normed input, each
    row-parallel one is summed over the group (g), and the logits of a
    vocab-parallel lm_head are gathered, so every rank returns the whole
    logits. `gather_fn(module)` returns the module to compute with in place
    of a stored one (FSDP's gathered weights, `parallel/fsdp.py`): it is
    applied to the model once, and to each layer inside its body, so that
    remat gathers the layer again in the backward."""
    cfg = model.cfg
    top = gather_fn(model) if gather_fn is not None else model
    B, S = tokens.shape
    x = top.embed[tokens]
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    for li, layer in enumerate(model.layers):
        fn = attention_fn if attention_fn is not None else make_attention_fn(cfg, li)
        args = (layer, x, cfg, cos, sin, fn, tp_group, gather_fn)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer, *args, use_reentrant=False)
        else:
            x = _layer(*args)
    x = rms_norm(x, top.final_norm, cfg.norm_eps)
    return _head_logits(x, top, cfg, tp_group)


def loss_fn(model: LlamaModel, tokens: torch.Tensor,
            attention_fn: Optional[Callable] = None, tp_group=None,
            gather_fn: Optional[Callable[[nn.Module], nn.Module]] = None) -> torch.Tensor:
    """Next-token cross-entropy on fp32 logits, mean over positions
    (`fa2_triton_tpu/models/llama.py:loss_fn`); `tp_group` and `gather_fn`
    as in `forward`."""
    logits = forward(model, tokens[:, :-1], attention_fn, tp_group=tp_group, gather_fn=gather_fn)
    targets = tokens[:, 1:]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer (k, v) zeros [batch, Hkv, max_len, hd] in cfg.dtype: the
    cache of `forward_with_cache`, BHSD like the serving cache
    (`runtime/kv_cache.py`), so the kernel reads its rows as they lie (JAX's
    is BSHD). `device` defaults to the GPU (`resolve_device`)."""
    device = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device)) for _ in range(cfg.n_layers)]


def make_cached_attention_fn(cfg: LlamaConfig) -> Callable:
    """Config-driven KV-cache attention for `forward_with_cache`: the bare
    (q, k_cache, v_cache, kv_len) wrapper for plain models, the per-layer
    form (an `li` keyword: window, softcap, scale) for the others, as JAX
    `models/llama.py:make_cached_attention_fn` chooses."""
    if cfg.sliding_window < 0 and cfg.attn_softcap == 0.0 and cfg.attn_scale is None:
        def attn(q, ck, cv, kv_len):
            return flash_attn_with_kv_cache(q, ck, cv, kv_len)
        return attn

    def attn(q, ck, cv, kv_len, li=0):
        return flash_attn_with_kv_cache(q, ck, cv, kv_len, softmax_scale=cfg.scale,
                                        window_left=cfg.window_for(li),
                                        softcap=cfg.attn_softcap)
    return attn


def write_cache_rows(cache: Tuple[torch.Tensor, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                     cache_len: int) -> None:
    """Write a step's k / v [B, S, Hkv, D] into a BHSD cache at rows
    cache_len..cache_len + S, in place (a functional update would copy the
    cache once a layer a step); rows past the cache's end raise, where JAX's
    `dynamic_update_slice` clamps the start and writes over earlier rows."""
    ck, cv = cache
    S = k.shape[1]
    if not 0 <= cache_len <= cache_len + S <= ck.shape[2]:
        raise ValueError(f"step rows {cache_len}..{cache_len + S} pass the cache's "
                         f"{ck.shape[2]} rows")
    ck[:, :, cache_len:cache_len + S] = k.transpose(1, 2)
    cv[:, :, cache_len:cache_len + S] = v.transpose(1, 2)


def forward_with_cache(
    model: LlamaModel,
    tokens: torch.Tensor,          # [B, S_step] int
    cfg: LlamaConfig,
    caches,                        # init_kv_cache's list of (k, v), BHSD
    cache_len: int,                # host int: tokens already in the cache
    cached_attention_fn: Callable,  # (q, k_cache, v_cache, kv_len[, li]) -> out
):
    """One prefill or decode step over the cache (port of JAX
    `models/llama.py:forward_with_cache`): row i of the step at position
    cache_len + i; each layer writes its S_step k / v rows in place at
    cache_len (`write_cache_rows`) and attends over the first cache_len +
    S_step rows. A `cached_attention_fn` taking an `li` keyword is
    specialised per layer (`make_cached_attention_fn`). Returns (logits
    [B, S_step, V] fp32, caches)."""
    cache_len = int(cache_len)
    B, S = tokens.shape
    x = model.embed[tokens]
    positions = (cache_len + torch.arange(S, device=tokens.device)).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    per_layer = "li" in inspect.signature(cached_attention_fn).parameters
    for li, (layer, cache) in enumerate(zip(model.layers, caches)):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
        write_cache_rows(cache, k, v, cache_len)
        kw = {"li": li} if per_layer else {}
        attn = cached_attention_fn(q, cache[0], cache[1], cache_len + S, **kw)
        x = _attn_out(layer, x, attn, cfg)
        x = _mlp_block(layer, x, cfg)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(x, model, cfg), caches


def prefill_forward(
    model: LlamaModel,
    tokens: torch.Tensor,       # [B, S_pad] int, right-padded
    true_len: torch.Tensor,     # [B] int
    tp_group=None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Prompt prefill: causal self-attention over the padded prompt with a
    padding mask. Returns (logits [B, S_pad, V] fp32, per-layer (k, v) in
    BSHD) for the cache fill. Under TP (`tp_group`) the k / v are this
    rank's heads, as its cache shard holds them."""
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
        x = _attn_out(layer, x, attn, cfg, tp_group)
        x = _mlp_block(layer, x, cfg, tp_group)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(x, model, cfg), kvs


def _decode_layers(model: LlamaModel, tokens: torch.Tensor, lens: torch.Tensor,
                   write_and_attend: Callable, tp_group=None) -> torch.Tensor:
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
        x = _attn_out(layer, x, attn[:, None], cfg, tp_group)
        x = _mlp_block(layer, x, cfg, tp_group)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(x[:, 0], model, cfg)


def decode_step(
    model: LlamaModel,
    tokens: torch.Tensor,       # [B] int — one token per slot
    caches,                     # runtime KV cache: list of layer dicts (BHSD)
    lens: torch.Tensor,         # [B] int32 — tokens already in each slot
    kv_cfg,                     # runtime.kv_cache.KVCacheConfig
    tp_group=None,
):
    """One batched decode step over the serving KV cache. Writes each slot's
    new k/v at `lens` IN PLACE (quantized when the cache is; saves a full
    cache copy per layer per step) and attends over lens + 1 rows, q
    zero-padded to the cache's head dim and the output cut back (JAX's
    `_pad`). Returns (logits [B, V], caches)."""
    from fa2_triton_tpu_torch.runtime.kv_cache import write_kv

    cfg = model.cfg
    kv_lens = (lens + 1).to(torch.int32)

    def write_and_attend(li, q, k, v):
        cache = caches[li]
        write_kv(cache, k, v, lens, kv_cfg)
        return decode_attention(
            pad_last(q, kv_cfg.head_dim_padded), cache["k"], cache["v"], kv_lens,
            cache.get("k_scale"), cache.get("v_scale"), softmax_scale=cfg.scale,
            window_left=cfg.window_for(li), softcap=cfg.attn_softcap)[..., :cfg.hd]

    return _decode_layers(model, tokens, lens, write_and_attend, tp_group), caches


def paged_decode_step(
    model: LlamaModel,
    tokens: torch.Tensor,       # [B] int — one token per slot
    pools,                      # per-layer page-pool dicts (shared pages)
    tables: torch.Tensor,       # [n_slots, max_pages] int32 block tables
    lens: torch.Tensor,         # [B] int32 — tokens already in each slot
    pcfg,                       # runtime.paged_cache.PagedCacheConfig
    tp_group=None,
):
    """One batched decode step over the paged KV cache
    (`fa2_triton_tpu/models/llama.py:paged_decode_step`): scatters each
    slot's new k/v through its table row at `lens`, IN PLACE, and attends
    over lens + 1 rows, q zero-padded to the pool's head dim and the output
    cut back. Returns (logits [B, V], pools)."""
    from fa2_triton_tpu_torch.runtime.paged_cache import write_tokens_paged

    cfg = model.cfg
    kv_lens = (lens + 1).to(torch.int32)

    def write_and_attend(li, q, k, v):
        pool = pools[li]
        write_tokens_paged(pool, tables, k, v, lens, pcfg)
        return paged_decode_attention(
            pad_last(q, pcfg.head_dim_padded), pool["k"], pool["v"], tables, kv_lens,
            pool.get("k_scale"), pool.get("v_scale"), softmax_scale=cfg.scale,
            window_left=cfg.window_for(li), softcap=cfg.attn_softcap)[..., :cfg.hd]

    return _decode_layers(model, tokens, lens, write_and_attend, tp_group), pools


def _cache_rows(store: dict, total: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first `total` rows of a one-slot cache view [1, Hkv, S, Dp] (and
    its scales [1, Hkv, 1, S]) as k, v in `dtype`, at the cache's padded
    head dim (the kernels' width): dequantized (value x scale in fp32, then
    cast, as the JAX package does) when the store is quantized, else
    views."""
    k, v = store["k"][:, :, :total], store["v"][:, :, :total]
    if "k_scale" in store:
        k = (k.float() * store["k_scale"][..., :total].transpose(2, 3)).to(dtype)
        v = (v.float() * store["v_scale"][..., :total].transpose(2, 3)).to(dtype)
    return k, v


def _chunk_layers(model: LlamaModel, tokens: torch.Tensor, chunk_len: int, cache_len: int,
                  write_and_view: Callable, tp_group=None) -> torch.Tensor:
    """The layer loop of one prefill chunk: `write_and_view(li, k, v)`
    stores layer `li`'s k/v of the chunk's `chunk_len` true tokens at
    `cache_len` and returns the k/v [1, Hkv, total, D] of the slot's first
    total = cache_len + chunk_len rows. The chunk's queries (row i at
    position cache_len + i) attend to them causally through `flash_fwd`
    (lens (total, total), q_off cache_len); padded rows past chunk_len are
    dead. Returns the logits [1, V] of the last true token."""
    cfg = model.cfg
    dev = tokens.device
    C = tokens.shape[1]
    total = cache_len + chunk_len
    x = model.embed[tokens]
    positions = (cache_len + torch.arange(C, device=dev))[None]
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    lens = torch.full((1, 2), total, dtype=torch.int32, device=dev)
    Dp = pad_head_dim(cfg.hd, dev)   # the caches' width
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
        kc, vc = write_and_view(li, k[:, :chunk_len], v[:, :chunk_len])
        o, _ = flash_fwd.flash_attn_forward(
            pad_last(q, Dp).transpose(1, 2), pad_last(kc, Dp), pad_last(vc, Dp), lens, cache_len,
            causal=True, softmax_scale=cfg.scale, window=_window_args(cfg, li),
            softcap=cfg.attn_softcap, seqlen_q_real=C, seqlen_k_real=total, static_skip=False,
            varlen=True)
        x = _attn_out(layer, x, o.transpose(1, 2)[..., :cfg.hd], cfg, tp_group)
        x = _mlp_block(layer, x, cfg, tp_group)
    x = rms_norm(x[:, chunk_len - 1], model.final_norm, cfg.norm_eps)
    return _logits(x, model, cfg)


def _check_chunk(tokens: torch.Tensor, chunk_len: int, cache_len: int, capacity: int) -> None:
    if tokens.shape[0] != 1 or not 0 < chunk_len <= tokens.shape[1] or cache_len < 0:
        raise ValueError(f"a chunk is tokens [1, C] with 0 < chunk_len <= C, got "
                         f"{tuple(tokens.shape)}, chunk_len {chunk_len}, cache_len {cache_len}")
    if cache_len + chunk_len > capacity:
        raise ValueError(f"chunk rows {cache_len}..{cache_len + chunk_len} pass the cache's "
                         f"{capacity} rows")


def chunk_prefill_step(
    model: LlamaModel,
    tokens: torch.Tensor,       # [1, C] int — one right-padded prompt chunk
    chunk_len: int,             # true tokens in the chunk
    cache_len: int,             # tokens already in the slot's cache
    caches,                     # runtime KV cache: list of layer dicts (BHSD)
    kv_cfg,                     # runtime.kv_cache.KVCacheConfig
    slot: int = 0,
    tp_group=None,
) -> torch.Tensor:
    """One bounded prefill chunk of `slot` over the contiguous serving cache
    (`fa2_triton_tpu/models/llama.py:chunk_prefill_step`): the chunk's
    queries attend to the cached prefix and the chunk itself, and the
    chunk's `chunk_len` true rows are written at `cache_len`, IN PLACE
    (quantized when the cache is; attention then reads the dequantized rows,
    the chunk's own included, as JAX does). Only true rows are written: JAX
    writes the whole padded chunk, and where cache_len + C passes the cache
    XLA clamps the write's start, moving the chunk over earlier rows
    (ROADMAP.md queue C). A chunk whose true rows pass the cache raises.
    Returns the logits [1, V] of the chunk's last true token."""
    from fa2_triton_tpu_torch.runtime.kv_cache import write_kv

    _check_chunk(tokens, chunk_len, cache_len, kv_cfg.max_seq_padded)
    total = cache_len + chunk_len
    offset = torch.tensor([cache_len], dtype=torch.int32)

    def write_and_view(li, k, v):
        view = {name: t[slot:slot + 1] for name, t in caches[li].items()}
        write_kv(view, k, v, offset, kv_cfg)
        return _cache_rows(view, total, kv_cfg.compute_dtype)

    return _chunk_layers(model, tokens, chunk_len, cache_len, write_and_view, tp_group)


def paged_chunk_prefill_step(
    model: LlamaModel,
    tokens: torch.Tensor,       # [1, C] int — one right-padded prompt chunk
    chunk_len: int,
    cache_len: int,
    pools,                      # per-layer page-pool dicts (shared pages)
    tables: torch.Tensor,       # [n_slots, max_pages] int32 block tables (device)
    slot: int,
    pcfg,                       # runtime.paged_cache.PagedCacheConfig
    tp_group=None,
) -> torch.Tensor:
    """`chunk_prefill_step` over the page pool: the chunk's true rows are
    scattered in place through the slot's table (`write_tokens_paged`; the
    caller has allocated their pages, and rows below cache_len, shared
    prefix pages included, are never written), then the slot's first
    ceil(total / page) pages are gathered into a contiguous view for the
    attention kernel. Returns the logits [1, V] of the last true token."""
    from fa2_triton_tpu_torch.runtime.paged_cache import write_tokens_paged

    _check_chunk(tokens, chunk_len, cache_len, pcfg.max_seq)
    total = cache_len + chunk_len
    n = -(-total // pcfg.page_size)
    trow = tables[slot:slot + 1]
    pages = trow[0, :n].long()
    # Made on the device: a host tensor would be copied, and the host would
    # wait for the device, in every layer.
    position = torch.full((1,), cache_len, dtype=torch.int32, device=tables.device)
    Hkv, D = pcfg.n_kv_heads, pcfg.head_dim_padded

    def write_and_view(li, k, v):
        pool = pools[li]
        write_tokens_paged(pool, trow, k, v, position, pcfg)
        view = {name: pool[name][pages].transpose(0, 1).reshape(1, Hkv, -1, D)
                for name in ("k", "v")}
        for name in ("k_scale", "v_scale"):
            if name in pool:   # [n, Hkv, 1, page] -> [1, Hkv, 1, n * page]
                view[name] = pool[name][pages].permute(1, 2, 0, 3).reshape(1, Hkv, 1, -1)
        return _cache_rows(view, total, pcfg.compute_dtype)

    return _chunk_layers(model, tokens, chunk_len, cache_len, write_and_view, tp_group)


QUANTIZABLE_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def shallow_copy(model: LlamaModel) -> LlamaModel:
    """A new `LlamaModel` (and new layers) holding the same parameter
    tensors as `model`: replacing a weight of the copy leaves `model` as it
    was, and nothing is copied on the device."""
    def one(m: nn.Module) -> nn.Module:
        out = copy.copy(m)
        for d in ("_parameters", "_buffers", "_modules"):
            out.__dict__[d] = type(m.__dict__[d])(m.__dict__[d])
        return out

    out = one(model)
    out.layers = nn.ModuleList(one(layer) for layer in model.layers)
    return out


def replace_weight(module: nn.Module, name: str, value) -> None:
    """Set `module.name` to `value` (a module, a tensor or a Parameter) in
    place of the parameter of that name."""
    module._parameters.pop(name, None)
    setattr(module, name, value)


@torch.no_grad()
def quantize_model_params(model: LlamaModel, qdtype=torch.int8) -> LlamaModel:
    """Weight-only quantization (JAX `models/llama.py:quantize_model_params`):
    a new model in which every weight named in QUANTIZABLE_KEYS is a
    `QuantizedWeight` (int8 or float8_e4m3fn values, per-output-channel fp32
    scales, `ops/quant.py:quantize_weight`), which every path multiplies
    through `qmatmul`. The embedding, norms, biases and the MoE router and
    experts are shared with `model`, unquantized."""
    out = shallow_copy(model)
    for layer in out.layers:
        for key in QUANTIZABLE_KEYS[:-1]:
            if getattr(layer, key) is not None:
                replace_weight(layer, key,
                               QuantizedWeight(**quantize_weight(getattr(layer, key), qdtype)))
    replace_weight(out, "lm_head", QuantizedWeight(**quantize_weight(model.lm_head, qdtype)))
    return out
