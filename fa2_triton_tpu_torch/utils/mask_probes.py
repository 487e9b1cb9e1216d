"""Mask probes: read, bit for bit, the dropout mask an attention kernel
applied, from its outputs on inputs built so that each output element is
one keep bit.

With q = 0 every score is 0 and the softmax is uniform, p = 1 / Sk:
  * forward, v = I (Sk = D): o[i, j] = keep[i, j] / (Sk (1 - p));
  * dk/dv, k = 0 as well and do = 2^g e_i for the g-th q head of a GQA
    group (Sq = D): dv[j, i] = sum_g 2^g keep_g[i, j] / (Sk (1 - p)), so
    the group's bits are the binary digits of the rounded count;
  * dq, k = I (Sk = D), every v_j = e_0 and every do_i = e_0 (so dp = 1 and
    delta_i = o[i, 0] = c_i): dq[i, j] Sk / scale = keep[i, j] / (1 - p) - c_i,
    and the dbias kernel reads the same quantity without the scale.
Each probe returns (the mask read from the outputs, the mask of
`utils/rng.py`, the residual) for the caller to compare: the residual is
the largest distance of a read quantity from the integer it rounds to
(relative for the dk/dv counts), so a kernel that applies the right mask
with the wrong normalisation (a sum over the dropped p, say) fails too. The
probes run on any device (the plain twins on the CPU, the kernels on CUDA
tensors).
"""
from __future__ import annotations

from typing import Tuple

import torch

from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd, varlen
from fa2_triton_tpu_torch.utils.rng import packed_dropout_keep_mask

Probe = Tuple[torch.Tensor, torch.Tensor, float]

# Largest residual a right kernel leaves in bf16: each read quantity is an
# integer times a bf16 rounding (relative 2^-9) plus fp32 sums; a forward
# that normalises by the dropped sum is off by ~|1 - kept share / (1 - p)|,
# several times this at the probes' 64-256 keys.
RESIDUAL_TOL = 0.03


def _bit(x: torch.Tensor, want: torch.Tensor) -> Probe:
    """A read quantity that should be 0 or 1 -> (mask, want, residual)."""
    return x > 0.5, want, float((x - x.round()).abs().max())


def _eye_rows(n: int, D: int, device, dtype) -> torch.Tensor:
    """[n, D] with row i = e_i (n <= D)."""
    return torch.eye(D, device=device, dtype=dtype)[:n]


def _group_weights(Hq: int, Hkv: int, device) -> torch.Tensor:
    """2^g for q head h = hk * G + g: [Hq]."""
    G = Hq // Hkv
    return 2.0 ** (torch.arange(Hq, device=device) % G).float()


def _group_bits(count: torch.Tensor, Hq: int, Hkv: int) -> torch.Tensor:
    """[B, Hkv, Sk, Sq] integer counts -> keep [B, Hq, Sq, Sk] (bit g of the
    count of kv head hk is q head hk * G + g)."""
    G = Hq // Hkv
    bits = (count[:, :, None] >> torch.arange(G, device=count.device).view(1, 1, G, 1, 1)) & 1
    return bits.reshape(count.shape[0], Hq, *count.shape[2:]).transpose(-1, -2).bool()


def _counts(x: torch.Tensor, want: torch.Tensor, Hq: int, Hkv: int) -> Probe:
    """dv read as [B, Hkv, Sk, Sq] group counts -> (mask, want, relative
    residual)."""
    c = x.round()
    resid = float(((x - c).abs() / c.clamp(min=1)).max())
    return _group_bits(c.to(torch.int64), Hq, Hkv), want, resid


def dense_probes(B: int, Hq: int, Hkv: int, D: int, p: float, seed: int, *, device,
                 dtype=torch.bfloat16, q_off: int = 0, kv_off: int = 0, rows: int = 96,
                 seqlen_q_real: int = None, seqlen_k_real: int = None) -> dict:
    """Forward, dk/dv, dq and dbias probes of `flash_fwd` / `flash_bwd` at
    global offsets q_off / kv_off with the dropout counter's real lengths.
    Returns {kernel: (read mask, rng mask, residual)}, masks [B, Hq, Sq, Sk]."""
    scale = D ** -0.5
    dkw = dict(causal=False, softmax_scale=scale, dropout_p=p, dropout_seed=seed,
               seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    zeros = lambda *s: torch.zeros(*s, device=device, dtype=dtype)  # noqa: E731
    lens = lambda sq, sk: torch.tensor([[q_off + sq, kv_off + sk]] * B, dtype=torch.int32,  # noqa: E731
                                       device=device)
    out = {}

    # Forward: q = 0, v = I, Sk = D.
    Sq, Sk = rows, D
    v = _eye_rows(D, D, device, dtype).expand(B, Hkv, D, D)
    o, _ = flash_fwd.flash_attn_forward(zeros(B, Hq, Sq, D), zeros(B, Hkv, Sk, D), v,
                                        lens(Sq, Sk), q_off, kv_off, **dkw)
    want = flash_fwd.dropout_mask(B, Hq, Sq, Sk, q_off, kv_off, p, seed, seqlen_q_real or Sq,
                                  seqlen_k_real or Sk, device)
    out["flash_fwd"] = _bit(o.float() * (Sk * (1 - p)), want)

    # dk/dv: q = k = 0, do = 2^g e_i, Sq = D (rows), Sk = `rows` columns.
    Sq, Sk = D, rows
    q, k, vr = zeros(B, Hq, Sq, D), zeros(B, Hkv, Sk, D), zeros(B, Hkv, Sk, D)
    w = _group_weights(Hq, Hkv, device).view(1, Hq, 1, 1)
    do = (_eye_rows(Sq, D, device, torch.float32) * w).to(dtype).expand(B, Hq, Sq, D)
    o, lse = flash_fwd.flash_attn_forward(q, k, vr, lens(Sq, Sk), q_off, kv_off, **dkw)
    _, _, dv = flash_bwd.flash_attn_backward(q, k, vr, do, o, lse, lens(Sq, Sk), q_off, kv_off,
                                             **dkw)
    want = flash_fwd.dropout_mask(B, Hq, Sq, Sk, q_off, kv_off, p, seed, seqlen_q_real or Sq,
                                  seqlen_k_real or Sk, device)
    out["flash_bwd_dkdv"] = _counts(dv.float()[..., :Sq] * (Sk * (1 - p)), want, Hq, Hkv)

    # dq and dbias: q = 0, k = I (Sk = D), v_j = e_0, do_i = e_0.
    Sq, Sk = rows, D
    q = zeros(B, Hq, Sq, D)
    k = _eye_rows(D, D, device, dtype).expand(B, Hkv, D, D)
    e0 = torch.zeros(D, device=device, dtype=dtype)
    e0[0] = 1
    vv, do = e0.expand(B, Hkv, Sk, D), e0.expand(B, Hq, Sq, D)
    bias = zeros(B, Hq, Sq, Sk)
    o, lse = flash_fwd.flash_attn_forward(q, k, vv, lens(Sq, Sk), q_off, kv_off, bias, **dkw)
    dq, _, _, dbias = flash_bwd.flash_attn_backward(q, k, vv, do, o, lse, lens(Sq, Sk), q_off,
                                                    kv_off, bias, compute_dbias=True, **dkw)
    c = o.float()[..., :1]                                  # delta_i = o[i, 0]
    want = flash_fwd.dropout_mask(B, Hq, Sq, Sk, q_off, kv_off, p, seed, seqlen_q_real or Sq,
                                  seqlen_k_real or Sk, device)
    out["flash_bwd_dq"] = _bit((dq.float() * (Sk / scale) + c) * (1 - p), want)
    out["flash_bwd_dbias"] = _bit((dbias.float() * Sk + c) * (1 - p), want)
    return out


def packed_probes(Hq: int, Hkv: int, D: int, p: float, seed: int, *, device,
                  dtype=torch.bfloat16, n_segments: int = 3, block: int = 128) -> dict:
    """The same probes on the varlen kernels: `n_segments` documents of D
    tokens packed at block-aligned starts (all but the first at nonzero
    packed offsets). Returns {kernel: (read mask, rng mask, residual)},
    masks [n_segments, Hq, D, D] over the documents' global packed rows /
    columns."""
    ext = -(-D // block) * block
    starts = [s * ext for s in range(n_segments)]
    T = ext * n_segments
    lens = [D] * n_segments
    scale = D ** -0.5
    kw = dict(causal=False, softmax_scale=scale, block_q=block, block_kv=block,
              dropout_p=p, dropout_seed=seed)
    eye = _eye_rows(D, D, device, torch.float32)

    def packed(per_doc, H):
        """[H, D, D] per-document rows -> [1, H, T, D], zero in the gaps."""
        x = torch.zeros(1, H, T, D, device=device)
        for s0 in starts:
            x[0, :, s0:s0 + D] = per_doc
        return x.to(dtype)

    def docs(x):
        """[.., T, D] -> [n_segments, .., D, D] document rows."""
        return torch.stack([x[..., s0:s0 + D, :] for s0 in starts])

    zeros = lambda H: torch.zeros(1, H, T, D, device=device, dtype=dtype)  # noqa: E731
    heads = torch.arange(Hq, device=device)
    want = torch.stack([packed_dropout_keep_mask(seed, p, heads, s0 + torch.arange(D, device=device),
                                                 s0 + torch.arange(D, device=device))
                        for s0 in starts])
    out = {}
    args = (starts, lens, lens)
    v = packed(eye.expand(Hkv, D, D), Hkv)
    o, _ = varlen.flash_attn_varlen_forward(zeros(Hq), zeros(Hkv), v, *args, **kw)
    out["varlen_fwd"] = _bit(docs(o[0]).float() * (D * (1 - p)), want)

    w = _group_weights(Hq, Hkv, device).view(Hq, 1, 1)
    do = packed(eye * w, Hq)
    q, k, vr = zeros(Hq), zeros(Hkv), zeros(Hkv)
    o, lse = varlen.flash_attn_varlen_forward(q, k, vr, *args, **kw)
    _, _, dv = varlen.flash_attn_varlen_backward(q, k, vr, do, o, lse, *args, **kw)
    out["varlen_dkdv"] = _counts(docs(dv[0]).float() * (D * (1 - p)), want, Hq, Hkv)

    e0 = torch.zeros(D, D, device=device)
    e0[:, 0] = 1
    q, k = zeros(Hq), packed(eye.expand(Hkv, D, D), Hkv)
    vv, do = packed(e0.expand(Hkv, D, D), Hkv), packed(e0.expand(Hq, D, D), Hq)
    o, lse = varlen.flash_attn_varlen_forward(q, k, vv, *args, **kw)
    dq, _, _ = varlen.flash_attn_varlen_backward(q, k, vv, do, o, lse, *args, **kw)
    c = docs(o[0]).float()[..., :1]
    out["varlen_dq"] = _bit((docs(dq[0]).float() * (D / scale) + c) * (1 - p), want)
    return out
