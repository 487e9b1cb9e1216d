"""Conversion into the port's models (port of `fa2_triton_tpu.models.convert`).

`llama_from_jax_params` takes the JAX package's LLaMA parameter tree as
numpy arrays and returns the port's `LlamaModel`; `llama_to_jax_params` is
the reverse mapping, of the parameters or of their gradients, so the two
sides can be compared leaf by leaf. `gpt2_from_jax_params` /
`gpt2_to_jax_params` do the same for the GPT-2 family (`models/gpt2.py`).
Parameter names and orientation are the same on both sides (`layers.3.wq`
is `tree["layers"][3]["wq"]`), so all are copies. The Hugging Face loaders
of the JAX module are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from fa2_triton_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from fa2_triton_tpu_torch.models.llama import LlamaConfig, LlamaModel
from fa2_triton_tpu_torch.utils import resolve_device

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_FP32_KEYS = ("attn_norm", "mlp_norm", "bq", "bk", "bv", "q_norm", "k_norm",
              "post_attn_norm", "post_mlp_norm")


def _to_torch(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; reinterpret the bits.
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype)


@torch.no_grad()
def llama_from_jax_params(params_np: Dict[str, Any], cfg: LlamaConfig,
                          device=None, dtype=None) -> LlamaModel:
    """Copy a JAX LLaMA parameter tree ({"embed", "layers": [...],
    "final_norm", "lm_head"}, leaves numpy arrays) into a `LlamaModel`.
    Matmul weights and the embedding take `dtype` (default `cfg.dtype`);
    norms and biases stay fp32. `device` defaults to the GPU
    (`resolve_device`)."""
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = LlamaModel(cfg, device=device)
    model.embed.copy_(_to_torch(params_np["embed"], dtype, device))
    model.lm_head.copy_(_to_torch(params_np["lm_head"], dtype, device))
    model.final_norm.copy_(_to_torch(params_np["final_norm"], torch.float32, device))
    if len(params_np["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params_np['layers'])} layers in the tree, cfg says {cfg.n_layers}")
    for layer, src in zip(model.layers, params_np["layers"]):
        if "router" in src:
            raise NotImplementedError("MoE layers are not ported yet (ROADMAP.md queue A: models)")
        unknown = set(src) - set(_MATMUL_KEYS) - set(_FP32_KEYS)
        if unknown:
            raise ValueError(f"unknown layer keys {sorted(unknown)}")
        for key in _MATMUL_KEYS:
            getattr(layer, key).copy_(_to_torch(src[key], dtype, device))
        for key in _FP32_KEYS:
            if key not in src:
                continue
            t = _to_torch(src[key], torch.float32, device)
            if getattr(layer, key) is None:
                setattr(layer, key, torch.nn.Parameter(t))
            else:
                getattr(layer, key).copy_(t)
    return model


def jax_path(name: str) -> Tuple[Union[str, int], ...]:
    """A port parameter name as a path into the JAX tree:
    "layers.3.wq" -> ("layers", 3, "wq"), "embed" -> ("embed",)."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16 of its own: widen (exactly) to fp32.
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


@torch.no_grad()
def gpt2_from_jax_params(params_np: Dict[str, Any], cfg: GPT2Config,
                         device=None, dtype=None) -> GPT2Model:
    """Copy a JAX GPT-2 parameter tree ({"wte", "wpe", "layers": [...],
    "lnf_g", "lnf_b"[, "lm_head"]}, leaves numpy arrays) into a
    `GPT2Model`. Matmul weights and embeddings take `dtype` (default
    `cfg.dtype`); norms and biases stay fp32. A tree with "lm_head" needs
    an untied cfg and one without it a tied cfg. `device` defaults to the
    GPU (`resolve_device`)."""
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if ("lm_head" in params_np) == cfg.tie_embeddings:
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the tree "
                         f"{'has' if 'lm_head' in params_np else 'lacks'} an lm_head")
    if len(params_np["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params_np['layers'])} layers in the tree, cfg says {cfg.n_layers}")
    model = GPT2Model(cfg, device=device)
    for name, p in model.named_parameters():
        path = jax_path(name)
        src = params_np["layers"][path[1]][path[2]] if path[0] == "layers" else params_np[path[0]]
        p.copy_(_to_torch(src, p.dtype, device))
    unknown = {k for layer in params_np["layers"] for k in layer} - set(
        dict(model.layers[0].named_parameters()))
    if unknown:
        raise ValueError(f"unknown layer keys {sorted(unknown)}")
    return model


@torch.no_grad()
def llama_to_jax_params(model: LlamaModel, grads: bool = False) -> Dict[str, Any]:
    """The JAX tree {"embed", "layers": [...], "final_norm", "lm_head"} of a
    `LlamaModel`'s parameters as numpy arrays (bf16 widened to fp32), or of
    their `.grad`s with `grads=True` (a parameter without a grad raises)."""
    tree: Dict[str, Any] = {"layers": [{} for _ in model.layers]}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        path = jax_path(name)
        if path[0] == "layers":
            tree["layers"][path[1]][path[2]] = _to_numpy(t)
        else:
            tree[path[0]] = _to_numpy(t)
    return tree


def gpt2_to_jax_params(model: GPT2Model, grads: bool = False) -> Dict[str, Any]:
    """The JAX tree {"wte", "wpe", "layers": [...], "lnf_g", "lnf_b"[,
    "lm_head"]} of a `GPT2Model`'s parameters or `.grad`s: the names map
    to paths as a `LlamaModel`'s do."""
    return llama_to_jax_params(model, grads)
