"""Single-step decode attention: the CUDA kernel's wrappers and their plain twins.

Port of `fa2_triton_tpu/ops/decode.py`: `decode_attention` over a contiguous
KV cache (B5, `_decode_kernel` with and without quant) and
`paged_decode_attention` over a shared page pool read through block tables
(B6, `_decode_kernel_paged` / `_paged_noquant`), all on the one kernel
template of `csrc/decode.cuh`. Layouts are the JAX ones without the 128-lane
pad of D:
- q [B, Hq, D]; contiguous caches [B, Hkv, S_max, D], scales
  [B, Hkv, 1, S_max] fp32;
- pools [n_pages, Hkv, page_size, D], tables [B, max_pages] int32 (position
  p of slot b lives at page tables[b, p // page_size], row p % page_size),
  scales [n_pages, Hkv, 1, page_size] fp32.

A cache is stored in q's dtype, or quantized (int8 or float8_e4m3fn) with
both scales. An fp8 cache without scales raises: the JAX package bitcasts it
to int8 and reads the bits as integers (ROADMAP queue C).

CPU tensors take the plain twins; CUDA tensors always launch the kernel or
raise. The kernel splits each (slot, KV head) into chunks of `CHUNK` logical
rows on a grid sized from shapes alone (`chunk_count`): the wrapper never
reads `kv_lens` on the host. Its scratch, fp32 partials (`partials_shape`)
and an int32 arrival counter per (slot, KV head), is kept per device and
stream and grown as needed, so a call allocates none (the kernel leaves the
counters 0).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops import _build
from fa2_triton_tpu_torch.ops.quant import QDTYPES
from fa2_triton_tpu_torch.utils import LOG2E, default_softmax_scale

# Kernel launches since the last reset: the total, and by variant
# ("contiguous bf16", "paged int8", ...: layout and cache dtype).
LAUNCHES = 0
VARIANT_LAUNCHES: Dict[str, int] = {}

HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8)
PAGE_MULTIPLE = 128  # the JAX package's page rule (decode.py:314)
# Logical cache rows per block of the kernel's grid: a mirror of CHUNK in
# csrc/decode.cuh (the C entry point refuses a grid of another chunk count).
CHUNK = 512

# Cache kinds of the C entry point (`enum CacheKind` in csrc/decode.cuh).
_CACHE_KINDS = {torch.int8: 1, torch.float8_e4m3fn: 2}
_DTYPE_NAMES = {torch.float32: "fp32", torch.float16: "fp16", torch.bfloat16: "bf16",
                torch.int8: "int8", torch.float8_e4m3fn: "fp8"}

_c_fn = None
# Scratch of the split-KV merge by (device index, stream): the fp32 partials
# (flat) and the int32 arrival counters, zero between launches. Launches on
# one stream run in order, so they share it.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    VARIANT_LAUNCHES.clear()


def variant(paged: bool, cache_dtype: torch.dtype) -> str:
    return f"{'paged' if paged else 'contiguous'} {_DTYPE_NAMES.get(cache_dtype, cache_dtype)}"


def _entry():
    global _c_fn
    if _c_fn is None:
        lib = _build.load()
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fa2_decode.argtypes = [I] * 6 + [P] * 8 + [I] * 3 + [F, F] + [I] + [P] * 3
        lib.fa2_decode.restype = I
        _c_fn = lib.fa2_decode
    return _c_fn


def chunk_count(cap: int) -> int:
    """Blocks of the kernel's grid per (slot, KV head): chunks of CHUNK
    logical rows covering cap = S_max (contiguous) or max_pages * page_size
    (paged). From shapes alone; at least 1."""
    return max(1, -(-cap // CHUNK))


def partials_shape(B: int, Hkv: int, n_chunks: int, G: int, D: int) -> Tuple[int, ...]:
    """The fp32 scratch of the split-KV merge: per (slot, KV head, chunk,
    query head of the group) the unnormalized output [D], then m and l."""
    return (B, Hkv, n_chunks, G, D + 2)


def live_chunks(kv_len: int, cap: int, window_left: int = -1) -> int:
    """How many chunks of one slot hold a row of [first, kv_len), the
    kernel's rule: its working blocks per KV head. For reports on the host
    (the wrapper never calls it)."""
    kv_len = min(max(kv_len, 0), cap)
    first = max(0, kv_len - 1 - window_left) if window_left >= 0 else 0
    return (kv_len - 1) // CHUNK - first // CHUNK + 1 if kv_len > first else 0


def _scratch(device: torch.device, stream: int, n_part: int,
             n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """At least n_part fp32 partials and n_counters zeroed int32 arrival
    counters for launches on `stream`, reused from the last call when they
    are large enough."""
    key = (device.index, stream)
    bufs = _SCRATCH.get(key)
    if bufs is None or bufs[0].numel() < n_part or bufs[1].numel() < n_counters:
        old = (0, 0) if bufs is None else (bufs[0].numel(), bufs[1].numel())
        bufs = (torch.empty(max(n_part, old[0]), dtype=torch.float32, device=device),
                torch.zeros(max(n_counters, old[1], 64), dtype=torch.int32, device=device))
        _SCRATCH[key] = bufs
    return bufs


def _check_scales(cache: torch.Tensor, k_scale, v_scale, shape) -> None:
    """A quantized cache takes both fp32 scales in the JAX layout `shape`;
    a cache in the compute dtype takes none."""
    quantized = cache.dtype in QDTYPES
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError(
            f"a {_DTYPE_NAMES[cache.dtype]} KV cache needs k_scale and v_scale (an fp8 cache "
            "without scales is not read as integers; see ROADMAP.md queue C)")
    if not quantized and (k_scale is not None or v_scale is not None):
        raise ValueError(f"scales are given for a {cache.dtype} cache; only int8 / "
                         "float8_e4m3fn caches take them")
    if quantized:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or tuple(s.shape) != tuple(shape) or not s.is_contiguous():
                raise ValueError(f"{name} must be a contiguous fp32 {list(shape)} tensor, got "
                                 f"{s.dtype} {list(s.shape)}"
                                 f"{'' if s.is_contiguous() else ' (not contiguous)'}")


def _check_tables(block_tables: torch.Tensor, B: int, page_size: int) -> None:
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B or not block_tables.is_contiguous():
        raise ValueError(f"block_tables must be a contiguous int32 [B={B}, max_pages] tensor, got "
                         f"{block_tables.dtype} {list(block_tables.shape)}")
    if page_size % PAGE_MULTIPLE != 0:
        raise ValueError(f"page_size must be a multiple of {PAGE_MULTIPLE}, got {page_size}")


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    kv_lens: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None, *, softmax_scale: Optional[float] = None,
    window_left: int = -1, softcap: float = 0.0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in fp32.
    q [B, Hq, D], caches [B, Hkv, S_max, D], kv_lens [B] (clamped to S_max),
    optional scales [B, Hkv, 1, S_max] -> [B, Hq, D]. A quantized cache is
    dequantized in fp32 first (exact values times scales)."""
    B, Hq, D = q.shape
    Hkv, S_max = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else default_softmax_scale(D)
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.transpose(-1, -2)
        vf = vf * v_scale.transpose(-1, -2)
    qf = q.float().view(B, Hkv, g, D)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale   # [B, Hkv, g, S]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    col = torch.arange(S_max, device=q.device).view(1, 1, 1, S_max)
    kv_len = kv_lens.to(device=q.device, dtype=torch.int64).clamp(max=S_max).view(B, 1, 1, 1)
    keep = col < kv_len
    if window_left >= 0:
        keep = keep & (col >= kv_len - 1 - window_left)
    s2 = torch.where(keep, s * LOG2E, torch.tensor(float("-inf"), device=q.device))
    m = s2.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    # Masked columns carry p = 0, but a cache row may hold anything: zero it
    # so 0 * NaN cannot reach the output.
    vf = torch.where(keep[:, :, 0, :, None], vf, torch.zeros((), device=q.device))
    o = torch.matmul(p, vf) / torch.where(l > 0, l, torch.ones_like(l))
    return o.reshape(B, Hq, D).to(q.dtype)


def _gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each slot's logical rows through its table: pool [n_pages, Hkv, P, X]
    -> [B, Hkv, max_pages * P, X]."""
    g = pool[tables.long()]                       # [B, max_pages, Hkv, P, X]
    B, M, H, P, X = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, H, M * P, X)


def _gather_scales(scale: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[n_pages, Hkv, 1, P] -> [B, Hkv, 1, max_pages * P]."""
    g = scale[tables.long()]                      # [B, max_pages, Hkv, 1, P]
    B, M, H, _, P = g.shape
    return g.permute(0, 2, 3, 1, 4).reshape(B, H, 1, M * P)


def paged_decode_attention_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, block_tables: torch.Tensor,
    kv_lens: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None, *, softmax_scale: Optional[float] = None,
    window_left: int = -1, softcap: float = 0.0,
) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: gather each slot's
    logical rows through its table, then the contiguous plain twin."""
    scales = (None, None) if k_scale is None else (
        _gather_scales(k_scale, block_tables), _gather_scales(v_scale, block_tables))
    return decode_attention_plain(
        q, _gather_pages(k_pool, block_tables), _gather_pages(v_pool, block_tables), kv_lens,
        *scales, softmax_scale=softmax_scale, window_left=window_left, softcap=softcap)


def _launch(q, k_cache, v_cache, kv_lens, k_scale, v_scale, block_tables, *,
            softmax_scale, window_left, softcap) -> torch.Tensor:
    """Check what the kernel takes and launch it on CUDA tensors."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"decode takes CPU or CUDA tensors, got {q.device}")
    B, Hq, D = q.shape
    paged = block_tables is not None
    if k_cache.dim() != 4 or k_cache.shape[3] != D or v_cache.shape != k_cache.shape \
            or (not paged and k_cache.shape[0] != B):
        raise ValueError(f"bad cache shapes {tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"for q {tuple(q.shape)}")
    Hkv, rows = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _build.DTYPE_CODES or v_cache.dtype != k_cache.dtype \
            or k_cache.dtype not in (q.dtype, *QDTYPES):
        raise TypeError(f"decode kernel takes fp32/fp16/bf16 q with caches of its dtype, int8 or "
                        f"float8_e4m3fn, got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if Hq % Hkv != 0 or Hq // Hkv not in GROUPS:
        raise ValueError(f"decode kernel takes Hq / Hkv in {GROUPS}, got {Hq} / {Hkv}")
    if kv_lens.shape != (B,) or kv_lens.dtype != torch.int32:
        raise ValueError("kv_lens must be an int32 [B] tensor")
    named = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("kv_lens", kv_lens)]
    named += [(n, t) for n, t in (("k_scale", k_scale), ("v_scale", v_scale),
                                  ("block_tables", block_tables)) if t is not None]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        # Rows are read as vector loads: contiguous, 16-byte aligned base.
        if not t.is_contiguous() or (name in ("q", "k_cache", "v_cache") and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous (and q/caches 16-byte aligned)")
    o = torch.empty_like(q)
    if B == 0:
        return o
    scale = softmax_scale if softmax_scale is not None else default_softmax_scale(D)
    max_pages = block_tables.shape[1] if paged else 0
    n_chunks = chunk_count(max_pages * rows if paged else rows)
    stream = _build.stream_ptr(q.device)
    part = counters = None
    if n_chunks > 1:
        part, counters = _scratch(q.device, stream,
                                  math.prod(partials_shape(B, Hkv, n_chunks, Hq // Hkv, D)), B * Hkv)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    status = _entry()(
        _build.DTYPE_CODES[q.dtype], _CACHE_KINDS.get(k_cache.dtype, 0), B, Hq, Hkv, D,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(), kv_lens.data_ptr(),
        ptr(k_scale), ptr(v_scale), ptr(block_tables),
        max_pages, rows, int(window_left), float(scale), float(softcap),
        n_chunks, ptr(part), ptr(counters), stream,
    )
    _build.check(status, "decode launch")
    LAUNCHES += 1
    name = variant(paged, k_cache.dtype)
    VARIANT_LAUNCHES[name] = VARIANT_LAUNCHES.get(name, 0) + 1
    return o


def decode_attention(
    q: torch.Tensor,                # [B, Hq, D] — one new token per sequence
    k_cache: torch.Tensor,          # [B, Hkv, S_max, D]: q's dtype, int8 or fp8
    v_cache: torch.Tensor,
    kv_lens: torch.Tensor,          # [B] int32 — valid tokens per sequence
    k_scale: Optional[torch.Tensor] = None,   # [B, Hkv, 1, S_max] fp32 if quantized
    v_scale: Optional[torch.Tensor] = None,
    *,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Returns attention output [B, Hq, D]. `window_left >= 0` attends only
    to the last window_left + 1 positions."""
    B, Hkv, S_max = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    _check_scales(k_cache, k_scale, v_scale, (B, Hkv, 1, S_max))
    kw = dict(softmax_scale=softmax_scale, window_left=window_left, softcap=softcap)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_lens, k_scale, v_scale, **kw)
    return _launch(q, k_cache, v_cache, kv_lens, k_scale, v_scale, None, **kw)


def paged_decode_attention(
    q: torch.Tensor,                # [B, Hq, D] — one new token per sequence
    k_pool: torch.Tensor,           # [n_pages, Hkv, page_size, D]: q's dtype, int8 or fp8
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,     # [B, max_pages] int32 physical page ids
    kv_lens: torch.Tensor,          # [B] int32 — valid tokens per sequence
    k_scale: Optional[torch.Tensor] = None,   # [n_pages, Hkv, 1, page_size] fp32 if quantized
    v_scale: Optional[torch.Tensor] = None,
    *,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Decode attention over a paged KV cache (vLLM-style block tables).
    Rows past each slot's length, and so table entries past its last live
    page, are never read; nor are rows before a window."""
    n_pages, Hkv, page_size = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    _check_tables(block_tables, q.shape[0], page_size)
    _check_scales(k_pool, k_scale, v_scale, (n_pages, Hkv, 1, page_size))
    kw = dict(softmax_scale=softmax_scale, window_left=window_left, softcap=softcap)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables, kv_lens,
                                            k_scale, v_scale, **kw)
    return _launch(q, k_pool, v_pool, kv_lens, k_scale, v_scale, block_tables, **kw)
