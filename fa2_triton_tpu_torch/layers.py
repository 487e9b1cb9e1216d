"""`FlashSelfAttention`: a drop-in attention module on the port's kernels.

Port of `fa2_triton_tpu/layers.py` (a flax linen module) as a
`torch.nn.Module`, field for field: projections, GQA head layout and
optional rotary embeddings around `flash_attn_func`. Parameters keep the
flax names and shapes (`q_proj.kernel` [F, H, hd], `k_proj.kernel` /
`v_proj.kernel` [F, Hkv, hd], `o_proj.kernel` [H * hd, F], biases of the
output shapes when `use_bias`), so `flash_self_attention_from_flax` loads a
linen module's params as they are.

Dropout: `self.training` takes the place of linen's `deterministic=False`.
In training mode with `dropout_p > 0` each call needs either an explicit
`dropout_seed` or a CPU `torch.Generator` (`dropout_rng`, given to the
constructor or to the call), from which one seed is drawn on the host; with
neither it raises (the linen module's missing-rng contract). In eval mode
there is no dropout and no seed.

Recomputation: under `torch.utils.checkpoint` the forward runs twice, and
the recompute must draw the same seed. Pass `torch.default_generator` as
`dropout_rng` (or an explicit `dropout_seed`): `checkpoint` restores the
default CPU generator's state before it recomputes
(`preserve_rng_state=True`, its default), so the second draw equals the
first. A generator of one's own is not restored by `checkpoint`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fa2_triton_tpu_torch.models.llama import apply_rope, rope_cos_sin
from fa2_triton_tpu_torch.ops.attention import flash_attn_func
from fa2_triton_tpu_torch.utils import resolve_device

# flax's lecun_normal: a normal of variance 1 / fan_in truncated at two
# standard deviations, rescaled by the truncated normal's own std.
_TRUNC_STD = 0.87962566103423978


class DenseGeneral(nn.Module):
    """flax `nn.DenseGeneral(features, axis=-1)`: y = x . kernel (+ bias),
    kernel [in_features, *features], computed in `dtype` (default: the
    promotion of x's and the kernel's dtypes, as flax promotes)."""

    def __init__(self, in_features: int, features: Sequence[int], use_bias: bool,
                 dtype: Optional[torch.dtype], param_dtype: torch.dtype, device=None):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((in_features, *self.features), dtype=param_dtype,
                                               device=device))
        std = math.sqrt(1.0 / in_features) / _TRUNC_STD
        nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(self.features, dtype=param_dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt).reshape(self.kernel.shape[0], -1))
        if self.bias is not None:
            y = y + self.bias.to(dt).reshape(-1)
        return y.reshape(*x.shape[:-1], *self.features)


class FlashSelfAttention(nn.Module):
    """Multi-head (optionally grouped-query) self-attention on the flash
    kernels. Input / output [batch, seqlen, features]; the optional `mask`
    is a [batch, seqlen] right-padding mask (True = valid) applied to both
    queries and keys, `bias` an additive attention bias, as in
    `flash_attn_func`."""

    def __init__(
        self,
        features: int,
        num_heads: int,
        num_kv_heads: Optional[int] = None,      # GQA / MQA; defaults to num_heads
        head_dim: Optional[int] = None,          # defaults to features // num_heads
        causal: bool = False,
        dropout_p: float = 0.0,
        window_size: Tuple[int, int] = (-1, -1),
        softcap: float = 0.0,
        use_rope: bool = False,
        rope_theta: float = 10000.0,
        dtype: Optional[torch.dtype] = None,     # compute / activation dtype
        param_dtype: torch.dtype = torch.float32,
        use_bias: bool = False,                  # bias on the projections
        dropout_rng: Optional[torch.Generator] = None,
        device=None,                             # default: the GPU (resolve_device)
    ):
        super().__init__()
        device = resolve_device(device)
        n_kv = num_kv_heads or num_heads
        if num_heads % n_kv:
            raise ValueError(f"num_heads {num_heads} is not a multiple of num_kv_heads {n_kv}")
        if not 0.0 <= dropout_p < 1.0:
            raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
        hd = head_dim or features // num_heads
        self.features, self.num_heads, self.num_kv_heads, self.head_dim = features, num_heads, n_kv, hd
        self.causal, self.dropout_p = causal, dropout_p
        self.window_size, self.softcap = tuple(window_size), softcap
        self.use_rope, self.rope_theta = use_rope, rope_theta
        self.dropout_rng = dropout_rng
        dense = lambda fin, feats: DenseGeneral(fin, feats, use_bias, dtype, param_dtype, device)  # noqa: E731
        self.q_proj = dense(features, (num_heads, hd))
        self.k_proj = dense(features, (n_kv, hd))
        self.v_proj = dense(features, (n_kv, hd))
        self.o_proj = dense(num_heads * hd, (features,))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, *, dropout_seed: Optional[int] = None,
                dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, _ = x.shape
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if self.use_rope:
            cos, sin = rope_cos_sin(torch.arange(S, device=x.device), self.head_dim, self.rope_theta)
            cos, sin = cos[None, :, None, :], sin[None, :, None, :]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        p = self.dropout_p if self.training else 0.0
        if p > 0.0 and dropout_seed is None and dropout_rng is None:
            dropout_rng = self.dropout_rng
            if dropout_rng is None:
                raise ValueError(
                    "FlashSelfAttention in training mode with dropout_p > 0 needs a dropout_seed "
                    "or a dropout_rng (a CPU torch.Generator, given to the constructor or the "
                    "call); eval() turns dropout off")
        out = flash_attn_func(
            q, k, v, attention_mask=mask, attention_bias=bias, dropout_p=p, causal=self.causal,
            window_size=self.window_size, softcap=self.softcap,
            dropout_seed=dropout_seed if p > 0.0 else None,
            dropout_rng=dropout_rng if p > 0.0 else None)
        return self.o_proj(out.reshape(B, S, self.num_heads * self.head_dim))


def flash_self_attention_from_flax(params, features: int, **kwargs) -> FlashSelfAttention:
    """A `FlashSelfAttention(features, **kwargs)` holding the linen module's
    params (`{"params": {...}}` or the inner dict, of numpy arrays)."""
    tree = params.get("params", params)
    layer = FlashSelfAttention(features, **kwargs)
    state = {}
    for name, leaves in tree.items():
        for leaf, value in leaves.items():
            state[f"{name}.{leaf}"] = torch.from_numpy(np.array(value))
    own = layer.state_dict()
    if set(state) != set(own):
        raise ValueError(f"flax params {sorted(state)} do not match the module's {sorted(own)}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: flax shape {tuple(value.shape)}, module {tuple(own[key].shape)}")
    layer.load_state_dict({k: v.to(own[k].dtype) for k, v in state.items()})
    return layer
