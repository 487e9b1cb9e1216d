"""FlashAttention-2 backward: the CUDA kernels' wrapper and their plain twin.

Port of `fa2_triton_tpu/ops/flash_bwd.py:flash_attn_backward` as
`flash_attn_func`'s autograd reaches it. The TPU schedules B12
(`_bwd_causal_strip_kernel`, the seq-2048 causal training backward), B2
(`_bwd_fused_kernel`), B3 (`_dq_kernel`, `_dkdv_kernel`) and B4
(`_dbias_kernel`) compute one function; on the GPU it is three deterministic
kernels in `csrc/flash_bwd.cu`: dq, dk/dv and dbias. Tensors are BHSD views
with any strides (the head dim contiguous), as the forward takes them; the
gradients come back as BHSD views of BSHD-contiguous memory, so the public
API transposes them back without a copy.

delta = rowsum(o * do) - dlse * log2e is plain PyTorch here, as it is plain
jnp in the JAX package (`flash_bwd.py:2321-2329`): the fold of the
logsumexp cotangent, gated on finite lse and dlse so dead rows stay zero.

Dropout (`dropout_p > 0`, `flash_bwd.py:_recompute_p_and_ds` l.133-156):
the kernels regenerate the forward's keep mask from the same seed and
counter; p stays undropped, dp becomes keep ? dp / (1 - p) : 0 inside
ds = p (dp - delta), and dv's operand becomes keep ? p / (1 - p) : 0.

CPU tensors take `flash_attn_backward_plain`; CUDA tensors always launch
the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops import _build
from fa2_triton_tpu_torch.ops.flash_fwd import (
    _check_cuda_args, _masks, bias_view, dropout_c_args, dropout_mask)
from fa2_triton_tpu_torch.utils import LOG2E

# Kernel launches since the last reset, per kernel (the smoke test reads
# these to show the training path went through the kernels).
LAUNCHES = {"flash_bwd_dq": 0, "flash_bwd_dkdv": 0, "flash_bwd_dbias": 0}
_KERNEL_IDS = {"flash_bwd_dq": 0, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 2}

_c_fn = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _entry():
    global _c_fn
    if _c_fn is None:
        fn = _build.load().fa2_flash_bwd
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        U = ctypes.c_uint
        fn.argtypes = ([I] * 8 + [P] * 6 + [P, I, I, I] + [P] * 4 + [P, P] + [I] * 5 + [F, F]
                       + [I, U, U, F, I, I, P])
        fn.restype = I
        _c_fn = fn
    return _c_fn


def compute_delta(o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                  dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """delta [B, Hq, Sq] fp32 = rowsum(o * do) - dlse * log2e (dlse only
    where both lse and dlse are finite)."""
    delta = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        safe = torch.isfinite(lse) & torch.isfinite(dlse)
        delta = delta - torch.where(safe, dlse.float(), torch.zeros_like(delta)) * LOG2E
    return delta.contiguous()


def _reduce_to_bias(ds_pre: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Sum [B, Hq, Sq, Sk] over the batch / head dims the bias broadcasts."""
    dims = [d for d in (0, 1) if bias.shape[d] == 1 and ds_pre.shape[d] > 1]
    return ds_pre.sum(dim=dims, keepdim=True) if dims else ds_pre


def flash_attn_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, lens: torch.Tensor,
    q_off: int = 0, kv_off: int = 0, bias: Optional[torch.Tensor] = None, *,
    causal: bool, softmax_scale: float, window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0, dlse: Optional[torch.Tensor] = None, compute_dbias: bool = False,
    dropout_p: float = 0.0, dropout_seed: int = 0,
    seqlen_q_real: Optional[int] = None, seqlen_k_real: Optional[int] = None,
):
    """The kernels' function in plain PyTorch, computed in fp32.

    Recomputes p = exp2(s * log2e - lse) from the base-2 LSE, then
    dp = do v^T, ds = p (dp - delta) (times the softcap's tanh' chain),
    dq = scale ds k, dk = scale ds^T q, dv = p^T do, with dk / dv summed
    over the GQA group and dbias = p (dp - delta) summed over the bias's
    broadcast batch / head dims. Rows past q_len and columns past kv_len
    are zeroed first, so padding that holds NaN cannot leak in. With
    dropout, dp and dv's p carry the forward's mask times 1 / (1 - p)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    q_len = lens[:, 0].to(device=dev, dtype=torch.int64)
    kv_len = lens[:, 1].to(device=dev, dtype=torch.int64)
    row_ok = ((q_off + torch.arange(Sq, device=dev))[None] < q_len[:, None]).view(B, 1, Sq, 1)
    col_ok = ((kv_off + torch.arange(Sk, device=dev))[None] < kv_len[:, None]).view(B, 1, Sk, 1)
    zero = torch.zeros((), device=dev)
    qf, dof = (torch.where(row_ok, x.float(), zero) for x in (q, do))
    kf, vf = (torch.where(col_ok, x.float(), zero).repeat_interleave(g, dim=1) for x in (k, v))
    delta = torch.where(row_ok[..., 0], compute_delta(o, do, lse, dlse), zero)

    s = torch.matmul(qf, kf.transpose(-1, -2)) * softmax_scale
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    if bias is not None:
        s = s + bias.float()
    finite = torch.isfinite(lse)
    keep = _masks(lens, q_off, kv_off, Sq, Sk, causal, window, dev) & finite[..., None]
    lse_safe = torch.where(finite, lse, zero)
    p = torch.where(keep, torch.exp2(s * LOG2E - lse_safe[..., None]), zero)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_dv = p
    if dropout_p > 0.0:
        keep_d = dropout_mask(B, Hq, Sq, Sk, q_off, kv_off, dropout_p, dropout_seed,
                              seqlen_q_real or Sq, seqlen_k_real or Sk, dev)
        drop = torch.where(keep_d, torch.tensor(1.0 / (1.0 - dropout_p), device=dev), zero)
        del keep_d
        dp = dp * drop
        p_dv = p * drop
    ds_pre = torch.where(keep, p * (dp - delta[..., None]), zero)
    ds = ds_pre * (1.0 - t * t) if softcap > 0.0 else ds_pre
    dq = torch.matmul(ds, kf) * softmax_scale
    dk = (torch.matmul(ds.transpose(-1, -2), qf) * softmax_scale).view(B, Hkv, g, Sk, D).sum(2)
    dv = torch.matmul(p_dv.transpose(-1, -2), dof).view(B, Hkv, g, Sk, D).sum(2)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if compute_dbias:
        return grads + (_reduce_to_bias(ds_pre, bias).to(bias.dtype),)
    return grads


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x itself if the kernels can read it (head dim contiguous, strides a
    multiple of 4 elements, 16-byte aligned base), else a BHSD view of a
    BSHD-contiguous copy (autograd may hand over e.g. an expanded do)."""
    if x.stride(3) == 1 and not any(s % 4 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0:
        return x
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def _launch(name: str, args) -> None:
    _build.check(_entry()(_KERNEL_IDS[name], *args), f"{name} launch")
    LAUNCHES[name] += 1


def flash_attn_backward(
    q: torch.Tensor,      # [B, Hq, Sq, D] (any strides, head dim contiguous)
    k: torch.Tensor,      # [B, Hkv, Sk, D]
    v: torch.Tensor,      # [B, Hkv, Sk, D]
    do: torch.Tensor,     # [B, Hq, Sq, D] cotangent of o
    o: torch.Tensor,      # [B, Hq, Sq, D] the forward's output
    lse: torch.Tensor,    # [B, Hq, Sq] fp32, base 2, the forward's
    lens: torch.Tensor,   # [B, 2] int32 (q_len, kv_len) global actual lengths
    q_off: int = 0,
    kv_off: int = 0,
    bias: Optional[torch.Tensor] = None,  # [1|B, 1|Hq, 1|Sq, 1|Sk]
    *,
    causal: bool,
    softmax_scale: float,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dlse: Optional[torch.Tensor] = None,  # [B, Hq, Sq] cotangent of lse
    compute_dbias: bool = False,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    seqlen_q_real: Optional[int] = None,   # dropout counter lengths (default: Sq, Sk)
    seqlen_k_real: Optional[int] = None,
):
    """Returns (dq, dk, dv) in the input dtypes, plus dbias
    [bias.shape[0], bias.shape[1], Sq, Sk] in the bias dtype when
    `compute_dbias`. Bitwise repeatable (no atomics)."""
    if compute_dbias and bias is None:
        raise ValueError("compute_dbias needs a bias")
    drop = dropout_c_args(dropout_p, dropout_seed)
    kw = dict(causal=causal, softmax_scale=softmax_scale, window=window, softcap=softcap,
              dlse=dlse, compute_dbias=compute_dbias, dropout_p=dropout_p,
              dropout_seed=dropout_seed, seqlen_q_real=seqlen_q_real, seqlen_k_real=seqlen_k_real)
    if q.device.type == "cpu":
        return flash_attn_backward_plain(q, k, v, do, o, lse, lens, q_off, kv_off, bias, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd takes CPU or CUDA tensors, got {q.device}")
    _check_cuda_args(q, k, v, lens)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for name, t in (("do", do), ("o", o)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be like q {tuple(q.shape)}, got {tuple(t.shape)} on {t.device}")
    if do.dtype != q.dtype:
        raise TypeError(f"do must have q's dtype {q.dtype}, got {do.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("lse must be an fp32 [B, Hq, Sq] tensor on q's device")
    do = _kernel_layout(do)
    delta = compute_delta(o, do, lse, dlse)
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Sk, Hkv, D), dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Sk, Hkv, D), dtype=v.dtype, device=q.device).transpose(1, 2)
    bv = bias_view(bias, q, Sk) if bias is not None else None
    dbias = None
    if compute_dbias:
        Bb, Hb = bias.shape[0], bias.shape[1]
        dbias = torch.empty((Bb, Hb, Sq, Sk), dtype=bias.dtype, device=q.device)
    else:
        Bb = Hb = 1
    if B == 0 or Hq == 0 or Sq == 0 or Sk == 0:
        for t in (dq, dk, dv) + ((dbias,) if dbias is not None else ()):
            t.zero_()
        return (dq, dk, dv) + ((dbias,) if dbias is not None else ())
    strides = (ctypes.c_longlong * 28)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        *(bv.stride() if bv is not None else (0, 0, 0, 0)),
        *(dbias.stride()[:3] if dbias is not None else (0, 0, 0)))
    args = (
        _build.DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Sk, D,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        bv.data_ptr() if bv is not None else None,
        _build.DTYPE_CODES[bv.dtype] if bv is not None else 0, Bb, Hb,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr() if dbias is not None else None,
        lens.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        int(q_off), int(kv_off), int(bool(causal)), int(window[0]), int(window[1]),
        float(softmax_scale), float(softcap), *drop,
        int(seqlen_q_real or Sq), int(seqlen_k_real or Sk), _build.stream_ptr(q.device),
    )
    _launch("flash_bwd_dq", args)
    _launch("flash_bwd_dkdv", args)
    if dbias is not None:
        _launch("flash_bwd_dbias", args)
        return dq, dk, dv, dbias
    return dq, dk, dv
