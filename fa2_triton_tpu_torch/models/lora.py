"""LoRA (low-rank adaptation) of the LLaMA family (port of
`fa2_triton_tpu/models/lora.py`).

The adapters are a module of their own (`LoRA`: per layer, per targeted 2-D
weight [in, out], A [in, r] and B [r, out] in an `nn.ParameterDict`), so an
optimizer over `lora.parameters()` trains them alone while the base model
stays frozen. `merge_lora` returns a model whose targeted weights are W +
(alpha / r) A B (summed in fp32, cast back to W's dtype) and which shares
every other tensor with the base, so every forward, serving and quantizing
path takes an adapted model unchanged and runs no second matmul. Under grad
the merged weights carry the adapters' gradients; `merged_model` is the
frozen form for the Engine.

The merged weights are made once per loss call, outside the layers' remat
regions, and held by the merged model: `torch.func.functional_call` would
put the base weights back before the backward recomputes a checkpointed
layer, which would then read the base weights.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable

import numpy as np
import torch
from torch import nn

from fa2_triton_tpu_torch.models.convert import _to_numpy, _to_torch
from fa2_triton_tpu_torch.models.llama import LlamaModel, replace_weight, shallow_copy
from fa2_triton_tpu_torch.utils import resolve_device

# 2-D projection weights adapters attach to by default (llama + MoE attention).
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


class LoRA(nn.Module):
    """Adapters: `layers[i][name]["a"]` [in, r] and `["b"]` [r, out] for
    each adapted weight `name` of layer i (the JAX adapter tree's paths)."""

    def __init__(self, layers: Iterable[Dict[str, Dict[str, torch.Tensor]]]):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: nn.ParameterDict({k: nn.Parameter(t) for k, t in ab.items()})
                           for name, ab in layer.items()})
            for layer in layers)


@torch.no_grad()
def init_lora(generator: torch.Generator, model: LlamaModel, rank: int = 8,
              targets: Iterable[str] = DEFAULT_TARGETS) -> LoRA:
    """Adapters for each targeted 2-D weight of each layer (MoE experts,
    which are 3-D, and quantized weights are skipped): A N(0, 1/fan_in)
    (drawn in fp32 on the weight's device, then cast to its dtype), B zeros,
    so the adapted model starts exactly at the base."""
    layers = []
    for layer in model.layers:
        adapters = {}
        for name in targets:
            w = getattr(layer, name, None)
            if not isinstance(w, torch.Tensor) or w.ndim != 2:
                continue
            fan_in, fan_out = w.shape
            a = torch.randn(fan_in, rank, generator=generator, dtype=torch.float32, device=w.device)
            adapters[name] = {"a": (a / math.sqrt(fan_in)).to(w.dtype),
                              "b": torch.zeros(rank, fan_out, dtype=w.dtype, device=w.device)}
        layers.append(adapters)
    return LoRA(layers)


def merge_lora(model: LlamaModel, lora: LoRA, alpha: float = 16.0) -> LlamaModel:
    """The base plus the adapters: a `shallow_copy` of `model` whose adapted
    weights are (W + (alpha / r) A B) in W's dtype, the sum in fp32 (r read
    off A). Differentiable in the adapters only: W enters detached."""
    out = shallow_copy(model)
    for layer, adapters in zip(out.layers, lora.layers):
        for name, ab in adapters.items():
            w = getattr(layer, name)
            delta = (ab["a"].float() @ ab["b"].float()) * (alpha / ab["a"].shape[1])
            merged = (w.detach().float() + delta).to(w.dtype)
            replace_weight(layer, name, merged)
    return out


@torch.no_grad()
def merged_model(model: LlamaModel, lora: LoRA, alpha: float = 16.0) -> LlamaModel:
    """`merge_lora` without a graph: a frozen model for the Engine, sharing
    its unadapted tensors with `model`."""
    out = merge_lora(model, lora, alpha)
    for layer, adapters in zip(out.layers, lora.layers):
        for name in adapters:
            setattr(layer, name, nn.Parameter(getattr(layer, name), requires_grad=False))
    return out


def lora_loss_fn(model: LlamaModel, lora: LoRA, tokens: torch.Tensor, loss_fn: Callable,
                 alpha: float = 16.0) -> torch.Tensor:
    """`loss_fn(merge_lora(model, lora, alpha), tokens)`: its backward
    reaches the adapters only. The base must be frozen
    (`model.requires_grad_(False)`), else this raises."""
    if any(p.requires_grad for p in model.parameters()):
        raise ValueError("freeze the base model first: model.requires_grad_(False)")
    return loss_fn(merge_lora(model, lora, alpha), tokens)


def lora_from_jax(tree: Dict[str, Any], device=None) -> LoRA:
    """The JAX adapter tree {"layers": [{name: {"a", "b"}}]} (numpy leaves)
    as a `LoRA`, each leaf in its own dtype. `device` defaults to the GPU
    (`resolve_device`)."""
    device = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)).dtype
        return _to_torch(a, dtype, device)

    return LoRA([{name: {k: conv(v) for k, v in ab.items()} for name, ab in layer.items()}
                 for layer in tree["layers"]])


@torch.no_grad()
def lora_to_jax(lora: LoRA, grads: bool = False) -> Dict[str, Any]:
    """The JAX adapter tree of a `LoRA`'s parameters, or of their `.grad`s
    with `grads=True`, as numpy arrays (bf16 widened to fp32)."""
    def leaf(p):
        t = p.grad if grads else p
        if t is None:
            raise ValueError("an adapter has no gradient")
        return _to_numpy(t)

    return {"layers": [{name: {k: leaf(p) for k, p in ab.items()} for name, ab in layer.items()}
                       for layer in lora.layers]}
