"""Shared numeric / shape helpers (PyTorch port of `fa2_triton_tpu.utils.common`).

The TPU package also carries padding, interpret-mode and matmul-precision
helpers; the port needs none of them: its kernels mask their own ragged
edges, run compiled on the GPU, and fp32 matmuls on the GPU are true fp32
unless TF32 is enabled by the caller.
"""
from __future__ import annotations

import math

import torch

# log2(e): the kernels work in the base-2 exponent domain and store the
# logsumexp in log-base-2 units (the contract the JAX package keeps).
LOG2E = 1.44269504088896340736


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m


def next_power_of_2(x: int) -> int:
    return 1 if x <= 1 else 2 ** math.ceil(math.log2(x))


def default_softmax_scale(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)


def resolve_device(device=None) -> torch.device:
    """The device a constructor builds on: the one given, else the card.
    Entry points run on the GPU unless the caller asks for the CPU, so
    `None` without a GPU raises instead of quietly building on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to build on the CPU")
    return torch.device("cuda")
