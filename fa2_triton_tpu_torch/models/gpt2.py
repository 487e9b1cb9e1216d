"""GPT-2-style decoder LM on the port's attention kernels (port of
`fa2_triton_tpu/models/gpt2.py`).

LayerNorm with bias, learned absolute position embeddings, MHA (as many kv
heads as q heads), a tanh-approximated GELU MLP (`jax.nn.gelu`'s default),
a tied or untied head, pre-norm residuals. The model is an `nn.Module`
whose parameters keep the JAX names and orientation (`layers.3.w_qkv` is
[dim, 3 dim], applied as `x @ w_qkv`; norms and biases fp32, each bias cast
to the model dtype before its add, as JAX does), so converting a JAX tree
is a copy (`models/convert.py:gpt2_from_jax_params`).

Training attention is `flash_attn_func` (causal), so its forward and
backward take the routes `flash_fwd.forward_route` / `flash_bwd.
backward_route` pick at the head dim 64; the cached step is
`flash_attn_with_kv_cache` over `init_kv_cache`'s BHSD caches (JAX's are
BSHD), written in place. A position at or past `max_seq_len` raises, where
JAX's gather of `wpe` clamps it to the last row (ROADMAP.md queue C).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fa2_triton_tpu_torch.models.llama import write_cache_rows
from fa2_triton_tpu_torch.ops import flash_attn_func
from fa2_triton_tpu_torch.ops.attention import flash_attn_with_kv_cache
from fa2_triton_tpu_torch.ops.quant import qmatmul as _mm
from fa2_triton_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class GPT2Config:
    """Defaults: GPT-2 small (https://huggingface.co/openai-community/gpt2/
    blob/main/config.json: vocab 50257, n_embd 768, n_layer 12, n_head 12,
    n_inner 4 x 768, n_positions 1024, layer_norm_epsilon 1e-5, tied head)."""
    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = True

    @property
    def hd(self) -> int:
        return self.dim // self.n_heads


def _param(*shape, dtype, device, fill=None):
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class GPT2Layer(nn.Module):
    """One block's parameters, named as in the JAX layer dict."""

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        device = resolve_device(device)
        d, h, dt, f32 = cfg.dim, cfg.hidden_dim, cfg.dtype, torch.float32
        self.ln1_g = _param(d, dtype=f32, device=device, fill=1.0)
        self.ln1_b = _param(d, dtype=f32, device=device, fill=0.0)
        self.w_qkv = _param(d, 3 * d, dtype=dt, device=device)
        self.b_qkv = _param(3 * d, dtype=f32, device=device, fill=0.0)
        self.w_proj = _param(d, d, dtype=dt, device=device)
        self.b_proj = _param(d, dtype=f32, device=device, fill=0.0)
        self.ln2_g = _param(d, dtype=f32, device=device, fill=1.0)
        self.ln2_b = _param(d, dtype=f32, device=device, fill=0.0)
        self.w_fc = _param(d, h, dtype=dt, device=device)
        self.b_fc = _param(h, dtype=f32, device=device, fill=0.0)
        self.w_out = _param(h, d, dtype=dt, device=device)
        self.b_out = _param(d, dtype=f32, device=device, fill=0.0)


class GPT2Model(nn.Module):
    """Parameters of the GPT-2 LM: wte [V, dim], wpe [max_seq_len, dim],
    layers, lnf_g / lnf_b, and lm_head [dim, V] unless the head is tied.
    `model(tokens)` runs `forward`. `device` defaults to the GPU
    (`resolve_device`)."""

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = _param(cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=device)
        self.wpe = _param(cfg.max_seq_len, cfg.dim, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(GPT2Layer(cfg, device) for _ in range(cfg.n_layers))
        self.lnf_g = _param(cfg.dim, dtype=torch.float32, device=device, fill=1.0)
        self.lnf_b = _param(cfg.dim, dtype=torch.float32, device=device, fill=0.0)
        self.lm_head = (None if cfg.tie_embeddings else
                        _param(cfg.dim, cfg.vocab_size, dtype=cfg.dtype, device=device))

    def forward(self, tokens, positions=None):
        return forward(self, tokens, positions=positions)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: GPT2Config, device=None) -> GPT2Model:
    """Random model: matmul weights and both embeddings N(0, 1/fan_in)
    (drawn in fp32 on the generator's device, then cast), norms 1, biases 0
    (the JAX `init_params` distribution; the numbers differ)."""
    device = generator.device if device is None else device
    model = GPT2Model(cfg, device=device)

    def fill(p: torch.Tensor, fan_in: int):
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=device)
        p.copy_(x.div_(math.sqrt(fan_in)))

    for layer in model.layers:
        fill(layer.w_qkv, cfg.dim)
        fill(layer.w_proj, cfg.dim)
        fill(layer.w_fc, cfg.dim)
        fill(layer.w_out, cfg.hidden_dim)
    fill(model.wte, cfg.dim)
    fill(model.wpe, cfg.dim)
    if model.lm_head is not None:
        fill(model.lm_head, cfg.dim)
    return model


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _block(layer: GPT2Layer, x: torch.Tensor, cfg: GPT2Config,
           cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           cache_len: int = 0) -> torch.Tensor:
    B, S, _ = x.shape
    h = layer_norm(x, layer.ln1_g, layer.ln1_b, cfg.norm_eps)
    qkv = _mm(h, layer.w_qkv) + layer.b_qkv.to(x.dtype)
    q, k, v = (t.reshape(B, S, cfg.n_heads, cfg.hd) for t in qkv.split(cfg.dim, dim=-1))
    if cache is not None:
        write_cache_rows(cache, k, v, cache_len)
        attn = flash_attn_with_kv_cache(q, cache[0], cache[1], cache_len + S)
    else:
        attn = flash_attn_func(q, k, v, causal=True)
    x = x + _mm(attn.reshape(B, S, cfg.dim), layer.w_proj) + layer.b_proj.to(x.dtype)
    h = layer_norm(x, layer.ln2_g, layer.ln2_b, cfg.norm_eps)
    m = F.gelu(_mm(h, layer.w_fc) + layer.b_fc.to(x.dtype), approximate="tanh")
    return x + _mm(m, layer.w_out) + layer.b_out.to(x.dtype)


def _embed(model: GPT2Model, tokens: torch.Tensor, positions: torch.Tensor, top: int,
           cfg: GPT2Config) -> torch.Tensor:
    """wte[tokens] + wpe[positions]; `top` is a host bound of the largest
    position, held below max_seq_len (JAX clamps the gather instead)."""
    if top >= cfg.max_seq_len:
        raise ValueError(f"position {top} is past the {cfg.max_seq_len} learned positions")
    return model.wte[tokens] + model.wpe[positions]


def _head(model: GPT2Model, x: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    x = layer_norm(x, model.lnf_g, model.lnf_b, cfg.norm_eps)
    if model.lm_head is None:
        return (x @ model.wte.T).float()
    return _mm(x, model.lm_head).float()


def forward(model: GPT2Model, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward -> logits [B, S, vocab] fp32, differentiable.
    Explicit `positions` are checked against max_seq_len by one read of
    their maximum."""
    S = tokens.shape[1]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
        top = S - 1
    else:
        top = int(positions.max())
    cfg = model.cfg
    x = _embed(model, tokens, positions, top, cfg)
    for layer in model.layers:
        x = _block(layer, x, cfg)
    return _head(model, x, cfg)


def loss_fn(model: GPT2Model, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy on fp32 logits, mean over positions."""
    logits = forward(model, tokens[:, :-1])
    targets = tokens[:, 1:]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int,
                  device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer (k, v) zeros [batch, n_heads, max_len, hd] in cfg.dtype
    (BHSD; JAX's are BSHD). `device` defaults to the GPU (`resolve_device`)."""
    device = resolve_device(device)
    shape = (batch, cfg.n_heads, max_len, cfg.hd)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device)) for _ in range(cfg.n_layers)]


def forward_with_cache(model: GPT2Model, tokens: torch.Tensor, cfg: GPT2Config, caches,
                       cache_len: int):
    """One prefill or decode step over the cache (JAX
    `models/gpt2.py:forward_with_cache`): row i at position cache_len + i,
    each layer's k / v written in place at cache_len. `cache_len` is a host
    int. Returns (logits [B, S_step, V] fp32, caches)."""
    cache_len = int(cache_len)
    S = tokens.shape[1]
    positions = cache_len + torch.arange(S, device=tokens.device)
    x = _embed(model, tokens, positions, cache_len + S - 1, cfg)
    for layer, cache in zip(model.layers, caches):
        x = _block(layer, x, cfg, cache=cache, cache_len=cache_len)
    return _head(model, x, cfg), caches
