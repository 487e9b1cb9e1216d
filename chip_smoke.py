#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`fa2_triton_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases (any failure raises, and the script exits nonzero):

1. Build the CUDA kernels from `fa2_triton_tpu_torch/csrc/` with nvcc for
   sm_90a (ptxas register / shared-memory report printed). Then a line per
   16-bit instantiation of the tensor-core kernels (the forward and the dq
   + dk/dv pair, with and without bias / softcap; dbias; the tri-square / diag and
   work-list backward; the packed forward, dq and dk/dv; bf16 and fp16,
   D 64 / 128 / 256, with and without dropout): ptxas
   registers and spills, and the HMMA instructions in its SASS (cuobjdump
   -sass of the built library); it fails where one has no tensor-core
   instruction, a bf16 D 128 one of the trainers' spills, or any packed
   forward spills.
2. Hold each kernel against its plain PyTorch twin at the serving slice's
   shapes, in bf16 and fp32, and time both with CUDA events. The decode
   kernel also runs over int8 and fp8 caches (B5 quant) and over shuffled
   page pools at page 128 and 512 (B6), each variant once per call: paged
   must equal contiguous bit for bit, and NaN in unused pages and rows must
   not change the output. Decode is timed by its kernel's device time
   (torch.profiler; at ~0.03 ms a call's CUDA-event time is the host's,
   printed beside it), with its split-KV grid: chunks per (slot, KV head)
   and the blocks whose chunk holds a live row. Before it, right after the
   build, a line sums up the 216 decode instantiations' ptxas registers
   and spills and the HMMA of the 16-bit ones; any spill fails.
3. Serve 16 requests through `runtime.serving.Engine` at the published
   widths of Mistral-7B-v0.3 (random bf16 weights from a seed), with the
   launch counters reset just before; every prefill dispatch and decode step
   must have gone through the kernels on every layer.
4. Recompute the served log-probs of two requests with the port's plain
   fp32 forward and compare. Then serve the same requests three more times:
   paged bf16 (tokens and log-probs equal to phase 3's), paged int8 with a
   57-page pool of 128 tokens (it runs dry, so a request is preempted, and
   every page comes back), and contiguous fp8; the quantized runs' log-probs
   are held against the fp32 forward.
5. Hold each backward kernel (dq, dk/dv) against its plain twin at the
   training shape (B 2, 32 / 8 heads, D 128, S 2047, causal), in bf16 and
   fp32, under the FA gradient contract, and time both: each 16-bit kernel's
   profiler time with its share of the bound and the aten backward's time,
   and at least 3x faster than its earlier FMA design's.
6. The bias path: `flash_attn_func` with a trainable per-head bias at the
   training shape, launch counts reset just before; the forward-with-bias,
   dq, dk/dv and dbias kernels must all have run, and out / dq / dk / dv /
   dbias are held against the plain twins. The tensor-core dbias kernel's
   profiler time, with its share of the bound, must be 3x faster than its
   FMA design's (phase 10 holds the bias path with dropout to the same).
7. Training at Mistral-7B-v0.3 widths: (i) 2 layers, every parameter
   gradient through the kernels and through the plain attention, both held
   to an fp32 plain run; (ii) full depth, `examples/train.py` with remat,
   AdamW and clipping for a few steps on one repeated batch, launch counts
   reset after its warm-up: every loss finite, the last below the first,
   and layers x steps dq / dk/dv launches, twice that of flash_fwd.
8. Packed varlen at Mistral-7B-v0.3 attention widths (32 / 8 heads, D 128,
   bf16, causal): documents of log-uniform length packed into T <= 16384,
   forward and backward through `flash_attn_varlen_func` with the launch
   counts reset just before (one launch of each varlen kernel); out, lse and
   gradients held against the fp32 and bf16 plain twins, dead positions
   exactly 0; kernel, plain and library times, each kernel's share of its
   bound and its time over the library's, each tensor-core kernel at least
   3x faster than its FMA design; the host time of the q-major and the
   kv-major launch table apart; packed against the same documents
   right-padded through `flash_attn_func(attention_mask=...)`.
9. Block-sparse at the same widths (B 2, S 4096, a local band plus an
   attention sink) through `flash_attn_blocksparse_func`, checked and timed
   the same way, with flex_attention as the library yardstick.
10. Attention dropout (p 0.1, bf16, 32 / 8 heads, D 128): mask probes that
   read every kernel's applied mask bit for bit (`utils/mask_probes.py`:
   forward, dq, dk/dv, dbias, varlen forward / dq / dk/dv; D 64/128/256,
   GQA 1 and 4, global offsets); `flash_attn_func` with dropout at B 2 x
   S 2048 (launch counts reset just before) against the fp32 oracle fed the
   same mask, the drop share over the whole mask grid, determinism in the
   seed, the bias path with dropout, phase 8's packed batch with dropout,
   and a full-width `FlashSelfAttention` trained for 3 AdamW steps (launch
   counts reset just before; eval equal to `flash_attn_func` without
   dropout; remat gradients equal bit for bit); times with and without
   dropout.
11. Long-context causal schedules at the same widths (B 1, bf16, causal, no
   mask): the split (one diag launch over leaves of 2048, one rectangle
   merged in place) at S 4096 and 4095, with split_leaf 1024 (three merged
   rectangles), the diag and a 2048 x 2048 rectangle alone and merged, and
   the strip at S 6144 and at 2048 queries against 4096 keys: launches of
   each default route, every kernel against its plain twin (fp32, bf16, and
   fp32 with dropout fed the same mask), the strip (the generic kernel's
   causal call) equal to the generic kernel bit for bit, times against the
   generic kernel (which must beat the FMA split at S 4096), the plain
   twins, the library and the bound; `flash_attn_func` forward + backward at S 4096
   through the split (FA rules against fp32; each of its four kernels'
   device time); and `examples/train.py` at
   full depth, batch 1 x seq 4096 (attention over 4095 tokens: the split),
   with finite, falling losses and 2 x layers x steps diag and merged-rect
   launches, none of the generic forward.
12. The causal backward schedules at Qwen1.5-7B attention widths (32 / 32
   heads, D 128, bf16, causal, no mask): the tri-square (B13) at B 2 x S
   2047, the work list (B14) at B 1 x S 8191 (four strips of 2048) and the split
   forced with split_leaf 2048 at S 4096 (one diag launch over two leaves,
   one rect), each reached through `flash_attn_backward`'s routing with its
   launches counted, the block partitions printed (blocks, per kv head,
   largest / mean work: at least one block per SM and at most 1.25), each
   kernel held against its plain twin (fp32, bf16 under the FA gradient
   contract, fp32 with dropout fed the same mask, two runs equal bit for
   bit) and timed against the generic dq + dk/dv pair (fused / pair
   printed; each must beat its own earlier FMA design), those times, its plain
   twin, the library and its bound; the trainers' forward at both Qwen
   shapes (the generic kernel: its time, the FMA design's, aten flash's
   causal forward on the same inputs, its bound and the share of it); then
   `examples/train.py --config qwen1.5-7b` at full depth, 2 x 2048
   (attention over 2047 tokens: the tri-square backward) and 1 x 8192 (the
   work list; 1 x 6144, the same route, only if 8192 runs out of memory),
   with finite, falling losses and layers x steps launches of the
   schedule's kernel, none of the dq / dk/dv pair.

Every kernel is also timed against PyTorch's own call for the same function
(`library_ms`, where one exists) and its bound on the H100 (`bound_ms`: the
larger of its operations over the tensor-core peak of its inputs' type —
bf16, or int8/fp8 for the quantized decode — and its bytes over the HBM
rate). The last line of stdout is a JSON object {"ok": true, "device":
{...}}; the line before it lists each kernel's (eighteen, and six dropout
entries) launches, error, times and bound. Without a CUDA device, or without the package beside this
script, it exits nonzero.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N_REQUESTS = 16
NEW_TOKENS = 32
# Prompt lengths are drawn log-uniformly in this range: serving traffic is
# heavy-tailed, and with seed 0 the 16 prompts land in buckets 128 (the TPU's
# B1 schedule) and 512-2048 (its B9 tri-square schedule).
PROMPT_RANGE = (100, 1800)
# The serve runs of phases 3-4, by name: each Engine's cache options
# (qdtype by torch dtype name).
SERVE_MODES = {"serve": {}, "serve paged bf16": {"paged": True},
               "serve paged int8": {"paged": True, "page_size": 128, "n_pages": 57,
                                    "qdtype": "int8"},
               "serve contiguous fp8": {"qdtype": "float8_e4m3fn"}}
ATTN_SEQ = (128, 1024, 2048)
DECODE_LENS = (1, 17, 300, 1024, 2048, 3000, 4000, 4096)
FP32_TOL = 1e-4                  # fp32 kernel vs fp32 plain, max abs
LSE_TOL = 1e-4                   # base-2 lse, fp32 math on both sides
# FA tolerance rule (tests/utils.py:19-20): a low-precision kernel may be off
# from the fp32 truth by at most 2x the low-precision plain version's own
# error, + 5e-5.
OUT_ERROR_MUL, OUT_ERROR_BIAS = 2.0, 5e-5
# FA gradient contract (tests/utils.py:21-23): at most 3x the low-precision
# plain version's error + 1e-5, and the dV waiver (summed error < 1e-4).
GRAD_ERROR_MUL, GRAD_ERROR_BIAS, DV_SUM_WAIVER = 3.0, 1e-5, 1e-4
# fp32 kernel vs fp32 plain gradients: sums of ~2000 fp32 products taken in
# another order.
FP32_GRAD_RTOL = 1e-4
# The training path's attention length: loss_fn feeds tokens[:, :-1] of
# --seq 2048 (the TPU's B9 forward / B12 backward route).
TRAIN_SEQ = 2048
BWD_SEQ = TRAIN_SEQ - 1
TRAIN_ARGV = ["--config", "mistral-7b-v0.3", "--steps", "4", "--batch", "2",
              "--seq", str(TRAIN_SEQ), "--remat", "--repeat-batch", "--lr", "3e-4",
              "--grad-clip", "1.0"]
# Packed varlen traffic (packed SFT / pretraining batches): document lengths
# log-uniform in this range from numpy.random.default_rng(0), drawn until the
# next one would push the packed total past VARLEN_T_MAX; starts aligned to
# the user blocks (block_q = block_kv = VARLEN_BLOCK).
VARLEN_DOC_RANGE = (64, 4096)
VARLEN_T_MAX = 16384
VARLEN_BLOCK = 128
# Block-sparse traffic: a local band of BS_BAND blocks below the diagonal plus
# the first column (an attention sink), causal, B x S.
BS_BATCH, BS_SEQ, BS_BAND = 2, 4096, 3
# Published peaks of one NVIDIA H100 SXM (data sheet; dense): each kernel's
# bound is the larger of operations / bf16 tensor-core rate and bytes / HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_8BIT_OPS = 1979e12          # fp8 and int8 tensor-core rate
PEAK_HBM_BYTES_S = 3.35e12
# Paged decode (B6) is checked at these page sizes (128: the smallest the
# kernels take; 512: the Engine's default).
DECODE_PAGES = (128, 512)
# A library yardstick whose bf16 error vs the fp32 truth exceeds this many
# times the bf16 plain twin's (+ bias) computes another function.
LIBRARY_ERROR_MUL, LIBRARY_ERROR_BIAS = 10.0, 1e-3


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(torch, a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def check_lse(torch, lse, lse_ref, what):
    if not torch.equal(torch.isinf(lse), torch.isinf(lse_ref)):
        raise AssertionError(f"{what}: lse -inf pattern differs from the plain version")
    fin = torch.isfinite(lse_ref)
    err = max_abs(torch, lse[fin], lse_ref[fin])
    if not err <= LSE_TOL:
        raise AssertionError(f"{what}: lse max abs err {err:.3e} > {LSE_TOL}")
    return err


def roofline(flops: float, nbytes: float, peak_ops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate of their inputs' type (bf16 by default) and the bytes
    over the HBM rate."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attn_bound(kernel: str, pairs: int, tokens: int, Hq: int, Hkv: int, D: int, elt: int) -> dict:
    """Bound of one attention kernel over `pairs` kept (query, key) pairs
    per q head and `tokens` live rows: 2 D operations per pair, head and
    S x S x D product (forward: q k^T, p v; dq: + do v^T, ds k; dk/dv:
    q k^T, do v^T, p^T do, ds^T q), and each live row of each input read
    once and of each output written once."""
    q_like = tokens * Hq * D * elt     # q, o, do, dq
    kv_like = tokens * Hkv * D * elt   # k, v, dk, dv
    row_vec = tokens * Hq * 4          # fp32 lse, delta
    products, nbytes = {
        "fwd": (2, 2 * q_like + 2 * kv_like + row_vec),
        "dq": (3, 3 * q_like + 2 * kv_like + 2 * row_vec),
        "dkdv": (4, 2 * q_like + 4 * kv_like + 2 * row_vec),
    }[kernel]
    return roofline(2 * D * products * pairs * Hq, nbytes)


def causal_pairs(lens) -> int:
    return sum(n * (n + 1) // 2 for n in lens)


def dbias_bound(B: int, Hq: int, Hkv: int, S: int, D: int, elt: int = 2) -> dict:
    """Bound of the dbias kernel on a causal call with a [1, Hq, S, S] bias:
    q k^T and do v^T over the causal pairs of every batch row; reads q, k,
    v, do, lse, delta and the bias's causal part, writes all of dbias."""
    pairs = B * causal_pairs([S])
    nbytes = (B * S * (2 * Hq + 2 * Hkv) * D * elt + 2 * B * Hq * S * 4
              + Hq * causal_pairs([S]) * elt + Hq * S * S * elt)
    return roofline(2 * D * 2 * pairs * Hq, nbytes)


def check_dbias_ms(ms: float, bound: dict, fma_key: str, what: str) -> float:
    """Print the tensor-core dbias kernel's share of its bound beside its
    FMA design's time, and fail unless it is DBIAS_SPEEDUP times faster
    than the top of that time. Returns the share in percent."""
    share = 100 * bound["bound_ms"] / ms
    print(f"[{what}] dbias_mma_kernel {ms:.3f} ms (profiler; the FMA design: "
          f"{FMA_DESIGN_MS[fma_key]} ms), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
          f"{share:.1f} % of the bound")
    beats_fma_design(fma_key, [ms], by=DBIAS_SPEEDUP)
    return share


def tight(torch, x, lens):
    """[B, S, H, D] right-padded rows -> the live rows back to back
    [sum(lens), H, D], the layout of PyTorch's varlen attention."""
    return torch.cat([x[b, :n] for b, n in enumerate(lens)]).contiguous()


def library_attention(torch, q, k, v, lens_q, lens_k, causal, scale, dropout_p=0.0):
    """PyTorch's own varlen FlashAttention-2 (`aten._flash_attention_forward`
    / `_backward`) on tight-packed bf16 rows: the `library_ms` yardstick of
    the attention kernels, timed beside them and called nowhere in the port.
    With `dropout_p` it draws its own Philox mask (a timing yardstick only).
    Returns (forward call, its outputs, backward call given do)."""
    cu = lambda lens: torch.tensor(np.cumsum([0, *lens]), dtype=torch.int32, device=q.device)
    cq, ck, mq, mk = cu(lens_q), cu(lens_k), max(lens_q), max(lens_k)

    def fwd():
        return torch.ops.aten._flash_attention_forward(q, k, v, cq, ck, mq, mk, dropout_p, causal,
                                                       False, scale=scale)
    out = fwd()

    def bwd(do):
        o, lse, rng, unused, _ = out
        return lambda: torch.ops.aten._flash_attention_backward(
            do, q, k, v, o, lse, cq, ck, mq, mk, dropout_p, causal, rng, unused, scale=scale)
    return fwd, out, bwd


def rounded_p_attention(torch, q, k, v, lens, scale):
    """Causal attention with p rounded to q's dtype before P V and fp32
    everywhere else (`compare_results_fa`'s upcast=False reference): the
    arithmetic of the 16-bit forward, as a second yardstick beside the
    plain twin, which rounds only o. BHSD in, o in q's dtype out."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    B, Hq, Sq, D = q.shape
    g = Hq // k.shape[1]
    s = torch.matmul(q.float(), k.float().repeat_interleave(g, 1).transpose(-1, -2))
    keep = flash_fwd._masks(lens, 0, 0, Sq, k.shape[2], True, (-1, -1), q.device)
    s = torch.where(keep, s * (scale * 1.4426950408889634), float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True).clamp(min=-1e30))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float().repeat_interleave(g, 1))
    return (o / torch.where(l > 0, l, torch.ones_like(l))).to(q.dtype)


def check_library(torch, what, got, ref32, plain_err):
    """The yardstick must compute the kernel's function: its bf16 error
    against the fp32 truth stays near the bf16 plain twin's (a wrong mask
    or length gives errors of order 0.1-1)."""
    err = max_abs(torch, got, ref32)
    if not err <= LIBRARY_ERROR_MUL * plain_err + LIBRARY_ERROR_BIAS:
        raise AssertionError(f"{what}: library err {err:.3e} vs plain {plain_err:.3e}: "
                             f"not the kernel's function")
    return err


def phase_build():
    from fa2_triton_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    print(f"[build] {path.relative_to(HERE)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)")


def phase_kernels(torch):
    """Each kernel vs its plain twin at the slice's shapes. Returns
    {kernel: {"max_abs_err", "ms", "plain_ms"}} at the served dtype (bf16)
    and the largest served shape."""
    from fa2_triton_tpu_torch.ops import flash_fwd, decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    result = {}
    B, Hq, Hkv, D = 2, 32, 8, 128
    scale = D ** -0.5
    bf16_errs = []
    for S in ATTN_SEQ:
        shape_q, shape_kv = (B, S, Hq, D), (B, S, Hkv, D)
        q32 = torch.randn(shape_q, generator=gen, device=dev) * 0.5
        k32 = torch.randn(shape_kv, generator=gen, device=dev) * 0.5
        v32 = torch.randn(shape_kv, generator=gen, device=dev) * 0.5
        # Right-padding like a bucketed prompt: one full row, one ~60%.
        n2 = int(S * 0.6) + 1
        lens = torch.tensor([[S, S], [n2, n2]], dtype=torch.int32, device=dev)
        kw = dict(causal=True, softmax_scale=scale)
        bhsd = lambda x: x.transpose(1, 2)  # the BSHD->BHSD view the API hands over
        o_ref, lse_ref = flash_fwd.flash_attn_forward_plain(bhsd(q32), bhsd(k32), bhsd(v32), lens, **kw)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (bhsd(x.to(dt)) for x in (q32, k32, v32))
            o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            err = max_abs(torch, o, o_ref)
            # lse: both sides compute it in fp32 from the same (rounded) inputs.
            o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw)
            lse_err = check_lse(torch, lse, lse_pl, f"flash_fwd S={S} {dt}")
            if dt == torch.float32:
                bound, rule = FP32_TOL, f"<= {FP32_TOL}"
            else:
                pl_err = max_abs(torch, o_pl, o_ref)
                bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
                rp_err = max_abs(torch, rounded_p_attention(torch, q, k, v, lens, scale), o_ref)
                rule = (f"<= 2 x plain bf16 err {pl_err:.3e} + 5e-5; {err / pl_err:.2f} x plain, "
                        f"{err / rp_err:.2f} x the bf16-p reference's {rp_err:.3e}")
                bf16_errs.append(err)
            ms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw))
            pms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw))
            if dt == torch.bfloat16:
                seq = [S, n2]
                lib_fwd, lib_out, _ = library_attention(
                    torch, *(tight(torch, x.to(dt), seq) for x in (q32, k32, v32)), seq, seq, True,
                    scale)
                lib_err = check_library(torch, f"flash_fwd S={S}", lib_out[0],
                                        tight(torch, bhsd(o_ref), seq), pl_err)
                fwd_extra = {"library_ms": cuda_ms(torch, lib_fwd),
                             **attn_bound("fwd", causal_pairs(seq), sum(seq), Hq, Hkv, D, 2)}
                print(f"[kernels] flash_fwd S={S} bf16: library (aten varlen flash) "
                      f"{fwd_extra['library_ms']:.3f} ms, err {lib_err:.3e}; bound "
                      f"{fwd_extra['bound_ms']:.3f} ms ({fwd_extra['bound_by']})")
            print(f"[kernels] flash_fwd B={B} Hq={Hq} Hkv={Hkv} D={D} S={S} {str(dt)[6:]}: "
                  f"max abs err {err:.3e} ({rule}), lse err {lse_err:.3e}; "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
            if not err <= bound:
                raise AssertionError(f"flash_fwd S={S} {dt}: err {err:.3e} > {bound:.3e}")
        result["flash_fwd"] = {"max_abs_err": max(bf16_errs), "ms": ms, "plain_ms": pms, **fwd_extra}
        del q32, k32, v32, o_ref, lse_ref, q, k, v, o, lse, o_pl, lse_pl

    slots, S_max = 8, 4096
    q32 = torch.randn((slots, Hq, D), generator=gen, device=dev) * 0.5
    k32 = torch.randn((slots, Hkv, S_max, D), generator=gen, device=dev) * 0.5
    v32 = torch.randn((slots, Hkv, S_max, D), generator=gen, device=dev) * 0.5
    kv_lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    o_ref = decode.decode_attention_plain(q32, k32, v32, kv_lens, softmax_scale=scale)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dt) for x in (q32, k32, v32))
        o = decode.decode_attention(q, k, v, kv_lens, softmax_scale=scale)
        torch.cuda.synchronize()
        err = max_abs(torch, o, o_ref)
        if dt == torch.float32:
            bound, rule = FP32_TOL, f"<= {FP32_TOL}"
        else:
            pl_err = max_abs(torch, decode.decode_attention_plain(q, k, v, kv_lens, softmax_scale=scale), o_ref)
            bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
            rule = f"<= 2 x plain bf16 err {pl_err:.3e} + 5e-5"
        run = lambda: decode.decode_attention(q, k, v, kv_lens, softmax_scale=scale)
        ms, call_ms = decode_kernel_ms(torch, run), cuda_ms(torch, run)
        pms = cuda_ms(torch, lambda: decode.decode_attention_plain(q, k, v, kv_lens, softmax_scale=scale))
        live = sum(DECODE_LENS) * Hkv * D * 2 * q.element_size()   # K and V bytes read
        grid = split_kv_counts(decode, S_max, Hkv)
        print(f"[kernels] decode slots={slots} Hq={Hq} Hkv={Hkv} D={D} S_max={S_max} "
              f"kv_lens={list(DECODE_LENS)} {str(dt)[6:]}: max abs err {err:.3e} ({rule}); "
              f"kernel {ms:.4f} ms ({live / (ms * 1e-3) / 1e9:.0f} GB/s of live K/V; the call "
              f"{call_ms:.4f} ms), split-KV grid {grid['n_chunks']} chunks of {grid['chunk']} "
              f"rows x {Hkv} KV heads x {slots} slots = {grid['grid_blocks']} blocks, "
              f"{grid['working_blocks']} working, plain {pms:.3f} ms")
        if not err <= bound:
            raise AssertionError(f"decode {dt}: err {err:.3e} > {bound:.3e}")
    # The library yardstick: each slot as a varlen sequence of one query.
    lib_fwd, lib_out, _ = library_attention(
        torch, q, *(tight(torch, x.transpose(1, 2), DECODE_LENS) for x in (k, v)),
        [1] * slots, list(DECODE_LENS), False, scale)
    lib_err = check_library(torch, "decode", lib_out[0], o_ref, pl_err)
    nbytes = 2 * slots * Hq * D * q.element_size() + live
    extra = {"library_ms": library_device_ms(torch, lib_fwd),
             "library_call_ms": cuda_ms(torch, lib_fwd),
             **roofline(4 * D * Hq * sum(DECODE_LENS), nbytes)}
    print(f"[kernels] decode bf16: library (aten varlen flash, one query per slot) "
          f"{extra['library_ms']:.4f} ms of device time (the call {extra['library_call_ms']:.4f} "
          f"ms), err {lib_err:.3e}; bound {extra['bound_ms']:.4f} ms ({extra['bound_by']})")
    result["decode"] = {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": pms, **extra,
                        **grid}
    result.update(decode_variants(torch, q32, k32, v32, kv_lens, scale))
    return result


def decode_kernel_ms(torch, fn) -> float:
    """Device time of one decode launch (torch.profiler): at some 0.03 ms
    the whole call's CUDA-event time is the host's, not the kernel's."""
    return kernel_ms(torch, fn, ["decode_kernel"], iters=10)["decode_kernel"]


def library_device_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call of a library yardstick: every kernel it
    launches, summed (torch.profiler), so that it stands beside the decode
    kernel's own device time; its CUDA-event call time is the host's too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [(e.key, e.count, getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    hits = [h for h in hits if h[2] > 0]
    if sum(n for _, n, _ in hits) < iters:
        raise AssertionError(f"the profiler recorded {hits} in {iters} library calls")
    ms = sum(us for _, _, us in hits) / iters / 1e3
    print(f"[profiler] library: {ms:.4f} ms of device time per call over {iters} calls, "
          f"kernels (name, launches): {[(k[:80], n) for k, n, _ in hits]}")
    return ms


def split_kv_counts(decode, cap: int, Hkv: int) -> dict:
    """The decode grid at phase 2's lengths: chunks per (slot, KV head)
    from the cap alone, and the blocks whose chunk holds a live row."""
    live = sum(decode.live_chunks(n, cap) for n in DECODE_LENS)
    return {"chunk": decode.CHUNK, "n_chunks": decode.chunk_count(cap),
            "grid_blocks": decode.chunk_count(cap) * Hkv * len(DECODE_LENS),
            "working_blocks": live * Hkv}


def page_pool(torch, caches, lens, page, seed, fill):
    """Contiguous caches [B, Hkv, S, D] and scales [B, Hkv, 1, S] (or None)
    -> a page pool in `runtime/paged_cache.py`'s layout and its tables: each
    slot's live pages at shuffled physical pages, everything else (page 0,
    the rows past each length) filled with `fill`, and table entries past a
    slot's last live page at the reserved page 0."""
    k = caches[0]
    B, Hkv, S, D = k.shape
    M = S // page
    perm = torch.randperm(B * M, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros(B, M, dtype=torch.int32)
    empty = lambda shape, dtype: torch.full(shape, fill, device=k.device).to(dtype)
    pools = [None if x is None else
             empty((B * M + 1, Hkv, 1, page) if x.shape[2] == 1 else (B * M + 1, Hkv, page, D), x.dtype)
             for x in caches]
    for b, n in enumerate(lens):
        for i in range(-(-n // page)):
            p, r0, r1 = int(perm[b * M + i]), i * page, min((i + 1) * page, n)
            tables[b, i] = p
            for pool, x in zip(pools, caches):
                if x is not None and x.shape[2] == 1:
                    pool[p, :, :, :r1 - r0] = x[b, :, :, r0:r1]
                elif x is not None:
                    pool[p, :, :r1 - r0] = x[b, :, r0:r1]
    return pools, tables.to(k.device)


def decode_variants(torch, q32, k32, v32, kv_lens, scale):
    """B5 quant and B6 at phase 2's decode shape: the same K/V quantized to
    int8 and fp8 with `quantize_tensor`, each held against its plain twin at
    matched bit-width (the plain twin dequantizes the same stored values, so
    the bf16 rule applies), then in shuffled page pools at page 128 and 512
    (bf16, int8, fp8), where paged must equal contiguous bit for bit and NaN
    in every unused page and row must not change it. Each call launches its
    variant once. Returns the kernels-line entries `decode_quant` and
    `paged_decode`, with every variant's numbers."""
    from fa2_triton_tpu_torch.ops import decode
    from fa2_triton_tpu_torch.ops.quant import quantize_tensor

    lens = [int(n) for n in kv_lens.tolist()]
    slots, Hq, D = q32.shape
    Hkv, S = k32.shape[1], k32.shape[2]
    q = q32.to(torch.bfloat16)
    kw = dict(softmax_scale=scale)
    stored = {"bf16": (k32.to(torch.bfloat16), v32.to(torch.bfloat16), None, None)}
    for name, qd in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        (kq, ks), (vq, vs) = (quantize_tensor(x, qd) for x in (k32, v32))
        stored[name] = (kq, vq, ks.transpose(-1, -2).contiguous(), vs.transpose(-1, -2).contiguous())
    # Library yardstick of the bf16 rows: the logical rows gathered back to
    # back outside the timed region, one query per slot (as for B5).
    lib_fwd, _, _ = library_attention(
        torch, q, *(tight(torch, x.transpose(1, 2), lens) for x in stored["bf16"][:2]),
        [1] * slots, lens, False, scale)
    lib_ms, lib_call_ms = library_device_ms(torch, lib_fwd), cuda_ms(torch, lib_fwd)
    flops = 4 * D * Hq * sum(lens)
    qo_bytes = 2 * slots * Hq * D * q.element_size()
    no_lib = ("none: no PyTorch call reads an int8/fp8 cache with per-token scales or a paged pool")
    variants = {}

    def launch_once(run, want):
        decode.reset_launches()
        out = run()
        torch.cuda.synchronize()
        if decode.VARIANT_LAUNCHES != {want: 1}:
            raise AssertionError(f"{want}: launches {decode.VARIANT_LAUNCHES}, not one of it")
        return out

    for name, caches in stored.items():
        quant = caches[2] is not None
        elt = caches[0].element_size()
        kv_bytes = sum(lens) * Hkv * (2 * D * elt + (8 if quant else 0))
        truth = caches if quant else (k32, v32, None, None)
        ref32 = decode.decode_attention_plain(q32, truth[0], truth[1], kv_lens, *truth[2:], **kw)
        plain = lambda: decode.decode_attention_plain(q, caches[0], caches[1], kv_lens, *caches[2:], **kw)
        pl_err = max_abs(torch, plain(), ref32)
        bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
        run = lambda: decode.decode_attention(q, caches[0], caches[1], kv_lens, *caches[2:], **kw)
        o = launch_once(run, decode.variant(False, caches[0].dtype))
        err = max_abs(torch, o, ref32)
        if not err <= bound:
            raise AssertionError(f"decode {name}: err {err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
        peak = PEAK_8BIT_OPS if quant else PEAK_BF16_FLOPS
        if quant:
            variants[f"contiguous {name}"] = {
                "max_abs_err": err, "ms": decode_kernel_ms(torch, run),
                "call_ms": cuda_ms(torch, run),
                "plain_ms": cuda_ms(torch, plain), "library_ms": None, "library_call_ms": None,
                **roofline(flops, kv_bytes + qo_bytes, peak), **split_kv_counts(decode, S, Hkv)}
        for page in DECODE_PAGES:
            pools, tables = page_pool(torch, caches, lens, page, seed=page, fill=0.0)
            prun = lambda: decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens,
                                                         *pools[2:], **kw)
            pplain = lambda: decode.paged_decode_attention_plain(q, pools[0], pools[1], tables,
                                                                 kv_lens, *pools[2:], **kw)
            op = launch_once(prun, decode.variant(True, caches[0].dtype))
            if not torch.equal(op, o):
                raise AssertionError(f"paged decode {name} page {page} differs from contiguous "
                                     f"(max abs {max_abs(torch, op, o):.3e})")
            nan_pools, nan_tables = page_pool(torch, caches, lens, page, seed=page, fill=float("nan"))
            op_nan = decode.paged_decode_attention(q, nan_pools[0], nan_pools[1], nan_tables, kv_lens,
                                                   *nan_pools[2:], **kw)
            if not (torch.equal(nan_tables, tables) and torch.equal(op_nan, op)):
                raise AssertionError(f"paged decode {name} page {page}: NaN in unused pages or rows "
                                     f"changed the output")
            del nan_pools, op_nan
            table_bytes = 4 * sum(-(-n // page) for n in lens)
            variants[f"paged {name} page {page}"] = {
                "max_abs_err": err, "ms": decode_kernel_ms(torch, prun),
                "call_ms": cuda_ms(torch, prun), "plain_ms": cuda_ms(torch, pplain),
                "library_ms": None if quant else lib_ms,
                "library_call_ms": None if quant else lib_call_ms,
                **roofline(flops, kv_bytes + qo_bytes + table_bytes, peak),
                **split_kv_counts(decode, tables.shape[1] * page, Hkv)}
            del pools
        print(f"[kernels] decode {name} cache (contiguous and paged at {DECODE_PAGES}): max abs err "
              f"{err:.3e} (<= 2 x plain {pl_err:.3e} + 5e-5); paged == contiguous bit for bit; "
              f"NaN in unused pages and rows: output unchanged")
    for v, e in variants.items():
        share = 100 * e["bound_ms"] / e["ms"]
        print(f"[kernels] {v}: kernel {e['ms']:.4f} ms ({share:.1f} % of its "
              f"bound {e['bound_ms']:.4f} ms, {e['bound_by']}; the call {e['call_ms']:.4f} ms), "
              f"{e['n_chunks']} chunks of {e['chunk']} rows, {e['working_blocks']} working blocks "
              f"of {e['grid_blocks']}, plain {e['plain_ms']:.3f} ms, library "
              + (f"{e['library_ms']:.4f} ms of device time, the call {e['library_call_ms']:.4f} "
                 "ms (aten varlen flash on the gathered rows)"
                 if e["library_ms"] is not None else no_lib))
    worst = lambda keys: max(variants[k]["max_abs_err"] for k in keys)
    return {
        "decode_quant": {**variants["contiguous fp8"],
                         "max_abs_err": worst(["contiguous int8", "contiguous fp8"]),
                         "library_reason": no_lib, "variants": variants_of(variants, "contiguous")},
        "paged_decode": {**variants["paged bf16 page 512"],
                         "max_abs_err": worst([k for k in variants if k.startswith("paged")]),
                         "library_reason": no_lib + " (the bf16 rows: aten varlen flash)",
                         "variants": variants_of(variants, "paged")},
    }


def variants_of(variants, prefix):
    return {k: {n: e[n] for n in ("max_abs_err", "ms", "call_ms", "plain_ms", "library_ms",
                                  "library_call_ms", "bound_ms", "n_chunks", "working_blocks")}
            for k, e in variants.items() if k.startswith(prefix)}


def served_prompts(cfg):
    """Phase 3's traffic: N_REQUESTS prompts of log-uniform length in
    PROMPT_RANGE, random tokens, from numpy.random.RandomState(0)."""
    rng = np.random.RandomState(0)
    lens = np.exp(rng.uniform(*np.log(PROMPT_RANGE), size=N_REQUESTS)).astype(int)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


def serve(torch, model, cfg, prompts, card: str, what: str):
    """Serve `prompts` (NEW_TOKENS each) through a fresh Engine with the
    cache options of SERVE_MODES[what], the launch counts reset just before,
    and check that every prefill dispatch and decode step went through the
    kernels on every layer, with the one decode variant the cache calls for.
    Returns the requests, the stats, the launches and the seconds of each
    decode step (host clock to the device's end)."""
    from fa2_triton_tpu_torch.ops import decode, flash_fwd
    from fa2_triton_tpu_torch.runtime import Engine

    torch.cuda.reset_peak_memory_stats()
    engine_kw = {k: getattr(torch, v) if k == "qdtype" else v for k, v in SERVE_MODES[what].items()}
    engine = Engine(model, cfg, n_slots=8, max_seq=4096, **engine_kw)
    store = engine.pcache.pools if engine.paged else engine.caches
    kv_bytes = sum(t.numel() * t.element_size() for layer in store for t in layer.values())
    want = decode.variant(engine.paged, store[0]["k"].dtype)
    free0 = engine.pcache.free_pages if engine.paged else None
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    # Host clock around each decode step, to the device's end: the step
    # reads its tokens back right after anyway.
    step_s, inner = [], engine._decode

    def timed_decode():
        t0 = time.perf_counter()
        out = inner()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out
    engine._decode = timed_decode
    flash_fwd.LAUNCHES = 0
    decode.reset_launches()
    stats = engine.run()
    launches = {"flash_fwd": flash_fwd.LAUNCHES, "decode": decode.LAUNCHES,
                "decode_variants": dict(decode.VARIANT_LAUNCHES)}
    lens = [len(p) for p in prompts]
    print(f"[{what}] {len(reqs)} requests, prompts {min(lens)}-{max(lens)} tokens: "
          f"prefill tokens {stats.prefill_tokens}, prefill dispatches {stats.prefill_dispatches}, "
          f"decode tokens {stats.decode_tokens}, decode steps {stats.decode_steps}, "
          f"wall {stats.wall_s:.3f} s, decode {stats.decode_tokens_per_s:.1f} tokens/s, "
          f"{1e3 * sum(step_s) / len(step_s):.2f} ms per decode step; KV cache "
          f"{kv_bytes / 1e9:.3f} GB, peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"[{card}]")
    print(f"[{what}] launches: {launches}")
    if not all(r.done and len(r.out_tokens) == NEW_TOKENS for r in reqs):
        raise AssertionError(f"{what}: not every request finished with its tokens")
    if launches["flash_fwd"] != cfg.n_layers * stats.prefill_dispatches or stats.prefill_dispatches == 0:
        raise AssertionError(f"{what}: flash_fwd launches {launches['flash_fwd']} != "
                             f"{cfg.n_layers} x {stats.prefill_dispatches} prefill dispatches")
    if launches["decode_variants"] != {want: cfg.n_layers * stats.decode_steps} or stats.decode_steps == 0:
        raise AssertionError(f"{what}: decode launches {launches['decode_variants']} != "
                             f"{{{want!r}: {cfg.n_layers} x {stats.decode_steps} decode steps}}")
    if engine.paged and engine.pcache.free_pages != free0:
        raise AssertionError(f"{what}: {engine.pcache.free_pages} pages free after the run, "
                             f"{free0} before")
    lps = np.array([r.out_logprobs for r in reqs])
    if not np.isfinite(lps).all():
        raise AssertionError(f"{what}: non-finite served log-probs")
    return reqs, stats, launches, step_s


def phase_serve(torch, card: str):
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params

    # Published widths of Mistral-7B-v0.3 (the trainer's preset names its
    # source), full depth: 7.25 B parameters, 14.5 GB in bf16.
    cfg = preset_config("mistral-7b-v0.3", torch.bfloat16)
    t0 = time.perf_counter()
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] Mistral-7B-v0.3 widths, {n_params / 1e9:.2f} B params bf16, random "
          f"(seed 0), init {time.perf_counter() - t0:.1f} s")
    prompts = served_prompts(cfg)
    reqs, _, launches, _ = serve(torch, model, cfg, prompts, card, "serve")
    return model, cfg, reqs, prompts, launches


def fp32_logprobs(torch, model, cfg, prompt, out_tokens):
    """Log-probs of `out_tokens` after `prompt` from the port's plain
    forward in fp32: the plain attention oracle, weights upcast one layer at
    a time (the whole model in fp32 would need 29 GB more)."""
    from fa2_triton_tpu_torch.models import llama as L
    from fa2_triton_tpu_torch.ops import flash_attn_reference

    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    toks = torch.tensor([prompt + out_tokens[:-1]], device="cuda")
    x = model.embed[toks].float()
    positions = torch.arange(toks.shape[1], device="cuda")[None]
    cos, sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)

    def attn(q, k, v):
        return flash_attn_reference(q, k, v, causal=True, softmax_scale=cfg.scale)

    for layer in model.layers:
        l32 = L.LlamaLayer(c32, device="cuda")
        l32.load_state_dict(layer.state_dict())
        x = L.attention_block(l32, x, c32, cos, sin, attn)
        x = L._mlp_block(l32, x, c32)
        del l32
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = x[0, len(prompt) - 1:] @ model.lm_head.float()
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, torch.tensor(out_tokens, device="cuda")[:, None])[:, 0].cpu().numpy()


# Served (bf16 weights, activations and KV cache; kernels) vs the fp32
# plain forward. bf16 keeps 8 mantissa bits: each of the 32 layers rounds
# the residual stream and every matmul input, and the served path rounds the
# cached k/v too. The bounds are ~2x the bf16 plain forward's own error
# against the same fp32 forward, measured on an NVIDIA H100 80GB HBM3 at
# 700 W (mean 0.011-0.017, max 0.024-0.068 over the five shortest requests):
# the FA rule applied to
# log-probs. A decode kv_len off by one fails them: one key short (kv_len =
# lens) gives mean errors of 0.05-0.06, one stale row too many gives max
# errors of 0.15-0.19 on these requests.
LOGPROB_MEAN_TOL = 0.03
LOGPROB_MAX_TOL = 0.1
# Paged vs contiguous serving: the same kernels on the same rows, so the
# same log-probs; anything above fp32 rounding of the log-softmax is a fault.
PAGED_LOGPROB_TOL = 1e-5


# The quantized runs (int8 / fp8 KV cache, everything else as above) vs the
# same fp32 forward: the served error adds the cache's quantization error.
# The bounds are ~2x the largest errors measured over two chip runs on an
# NVIDIA H100 80GB HBM3 at 700 W (requests 14 and 15, the same in both
# runs): int8 mean 0.0161-0.0163, max 0.0451-0.0485 (per-token steps of
# amax / 127 cost about what bf16's rounding does); fp8 e4m3 (3 mantissa
# bits) mean 0.0310-0.0338, max 0.0844-0.0883. A kernel that drops the v
# scale gives an int8 mean error of 1.02.
QUANT_LOGPROB_TOL = {"int8": (0.035, 0.1), "fp8": (0.07, 0.18)}   # (mean, max)


def check_logprobs(torch, model, cfg, reqs, prompts, what, mean_tol, max_tol):
    """The served log-probs of the two shortest requests that were not
    preempted (a wrong decode kv_len changes one key of the fewest, so these
    show it most) against the fp32 plain forward."""
    fresh = [j for j in range(len(prompts)) if reqs[j].folded == 0]
    errs = []
    for i in sorted(fresh, key=lambda j: len(prompts[j]))[:2]:
        ref = fp32_logprobs(torch, model, cfg, prompts[i], reqs[i].out_tokens)
        err = np.abs(np.array(reqs[i].out_logprobs) - ref)
        errs.append(err)
        print(f"[{what}] request {i} (prompt {len(prompts[i])}, {len(err)} tokens): served vs fp32 "
              f"plain forward log-probs: mean abs err {err.mean():.4f} (tol {mean_tol}), "
              f"max {err.max():.4f} (tol {max_tol})")
        if not (np.isfinite(ref).all() and err.mean() <= mean_tol and err.max() <= max_tol):
            raise AssertionError(f"{what}: request {i}'s served log-probs disagree with the fp32 "
                                 f"forward")
    return errs


def phase_check(torch, model, cfg, reqs, prompts):
    check_logprobs(torch, model, cfg, reqs, prompts, "check", LOGPROB_MEAN_TOL, LOGPROB_MAX_TOL)


def phase_serve_modes(torch, card, model, cfg, reqs, prompts):
    """Phase 3's requests served again: (1) paged bf16, default pool and
    page 512: tokens and log-probs equal to phase 3's; (2) paged int8, 57
    pages of 128 (the first wave reserves 56), so the pool runs dry
    mid-generation and a request must be preempted; (3) contiguous fp8.
    Returns the decode launches of each run by variant."""
    base = serve(torch, model, cfg, prompts, card, "serve paged bf16")
    for r, b in zip(base[0], reqs):
        if r.out_tokens != b.out_tokens:
            raise AssertionError(f"paged bf16: request {r.rid} tokens differ from contiguous")
    delta = max(np.abs(np.array(r.out_logprobs) - np.array(b.out_logprobs)).max()
                for r, b in zip(base[0], reqs))
    print(f"[serve paged bf16] greedy tokens equal to contiguous serving, request by request; "
          f"log-probs max |delta| {delta:.3e} (tol {PAGED_LOGPROB_TOL})")
    if not delta <= PAGED_LOGPROB_TOL:
        raise AssertionError(f"paged bf16: log-probs differ from contiguous by {delta:.3e}")
    runs = {"paged bf16": base[2]["decode_variants"]}
    for what in ("serve paged int8", "serve contiguous fp8"):
        name = what.split()[-1]
        q_reqs, _, launches, _ = serve(torch, model, cfg, prompts, card, what)
        folded = {r.rid: r.folded for r in q_reqs if r.folded}
        print(f"[{what}] preempted requests (rid: tokens folded into the prompt): {folded}")
        if SERVE_MODES[what].get("paged") and not folded:
            raise AssertionError(f"{what}: the 57-page pool never ran dry; nothing was preempted")
        check_logprobs(torch, model, cfg, q_reqs, prompts, what, *QUANT_LOGPROB_TOL[name])
        runs[what[6:]] = launches["decode_variants"]
    return runs


def check_grad(torch, name, g, ref, plain, what):
    """The FA gradient contract for one gradient against the fp32 truth
    `ref`, with the low-precision plain twin's error as the yardstick."""
    err, yard = max_abs(torch, g, ref), max_abs(torch, plain, ref)
    ok = err <= GRAD_ERROR_MUL * yard + GRAD_ERROR_BIAS
    if not ok and name in ("dv", "dbias"):
        ok = float((g.float() - ref.float()).abs().sum()) < DV_SUM_WAIVER
    if not ok:
        raise AssertionError(f"{what} {name}: err {err:.3e} > 3 x plain err {yard:.3e} + 1e-5")
    return err, yard


def check_fp32_grad(torch, name, g, plain, what):
    err = max_abs(torch, g, plain)
    bound = FP32_GRAD_RTOL * (1.0 + float(plain.float().abs().max()))
    if not err <= bound:
        raise AssertionError(f"{what} {name}: fp32 err {err:.3e} > {bound:.3e}")
    return err


def kernel_ms(torch, fn, names, iters=5):
    """Device time per launch of each named kernel (kernel names contain
    `names`; each launches once per call of `fn`), from torch.profiler over
    `iters` calls: the mean over the launches it recorded, printed with
    their count. In this long process it can miss a launch that ran (the
    packed forward with dropout: 4 of 5, while CUDA events time every call
    at one launch); `acc_events` does not bring it back."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in names:
        hits = [e for e in events if name in e.key]
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in hits)
        n = sum(e.count for e in hits)
        if not (us > 0 and 0 < n <= iters):
            raise AssertionError(f"the profiler recorded {n} launches of {name} in {iters} calls, "
                                 f"{us:.1f} us of device time")
        out[name] = us / n / 1e3
        print(f"[profiler] {name}: {out[name]:.3f} ms per launch over {n} of {iters} launches "
              f"recorded")
    return out


def attn_inputs(torch, gen, dev, S):
    B, Hq, Hkv, D = 2, 32, 8, 128
    q32 = torch.randn((B, S, Hq, D), generator=gen, device=dev) * 0.5
    k32 = torch.randn((B, S, Hkv, D), generator=gen, device=dev) * 0.5
    v32 = torch.randn((B, S, Hkv, D), generator=gen, device=dev) * 0.5
    do32 = torch.randn((B, S, Hq, D), generator=gen, device=dev)
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=dev)
    return q32, k32, v32, do32, lens


def phase_bwd_kernels(torch):
    """dq and dk/dv kernels vs the plain backward at the training shape
    (no padding, causal), fp32 and bf16; times at bf16."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    S, D = BWD_SEQ, 128
    bhsd = lambda x: x.transpose(1, 2)
    q32, k32, v32, do32, lens = (x if x.dtype == torch.int32 else bhsd(x)
                                 for x in attn_inputs(torch, gen, dev, S))
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, **kw)
    names = ("dq", "dk", "dv")
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (x.to(dt) for x in (q32, k32, v32, do32))
        o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
        grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw)
        plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, **kw)
        torch.cuda.synchronize()
        if dt == torch.float32:
            errs = {n: check_fp32_grad(torch, n, g, pl, "flash_bwd fp32")
                    for n, g, pl in zip(names, grads, plains)}
            rule = f"vs fp32 plain, <= {FP32_GRAD_RTOL} x (1 + max|grad|)"
        else:
            errs = {}
            for n, g, r, pl in zip(names, grads, refs, plains):
                errs[n], yard = check_grad(torch, n, g, r, pl, "flash_bwd bf16")
                errs[n + " plain"] = yard
            rule = "vs fp32 truth, FA gradient contract (<= 3 x plain bf16 err + 1e-5)"
        print(f"[bwd] B=2 Hq=32 Hkv=8 D={D} S={S} causal {str(dt)[6:]}: max abs errs "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" ({rule})")
    seq = [S, S]
    pairs = causal_pairs(seq)
    lib_fwd, _, lib_bwd = library_attention(torch, *(tight(torch, bhsd(x), seq) for x in (q, k, v)),
                                            seq, seq, True, kw["softmax_scale"])
    fwd_ms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw))
    fwd_pms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw))
    fwd_bound = attn_bound("fwd", pairs, 2 * S, 32, 8, D, 2)
    print(f"[bwd] bf16 forward at the training shape (both rows full): kernel {fwd_ms:.3f} ms, "
          f"plain {fwd_pms:.3f} ms, library {cuda_ms(torch, lib_fwd):.3f} ms, bound "
          f"{fwd_bound['bound_ms']:.3f} ms ({fwd_bound['bound_by']})")
    run = lambda: flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw)
    split = kernel_ms(torch, run, ("dq_mma_kernel", "dkdv_mma_kernel"))
    ms = cuda_ms(torch, run, iters=5)
    pms = cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, **kw),
                  iters=3, warmup=1)
    flops = 2 * 2 * 32 * (S * (S + 1) // 2) * D * 7   # 7 causal S x S x D products per head
    lib_run = lib_bwd(tight(torch, bhsd(do), seq))
    lib_errs = [check_library(torch, f"flash_bwd {n}", g, tight(torch, bhsd(r), seq), errs[n + " plain"])
                for n, g, r in zip(names, lib_run(), refs)]
    lib_ms = cuda_ms(torch, lib_run, iters=5)
    print(f"[bwd] library backward (aten varlen flash: dq, dk, dv in one call) {lib_ms:.3f} ms, "
          f"errs {', '.join(f'{e:.3e}' for e in lib_errs)}")
    out = {}
    for name, kernel, products in (("dq", "dq_mma_kernel", "dq"), ("dkdv", "dkdv_mma_kernel", "dkdv")):
        bound = attn_bound(products, pairs, 2 * S, 32, 8, D, 2)
        fma = float(FMA_DESIGN_MS[name])
        print(f"[bwd] {kernel} B 2 x S {S} bf16: {split[kernel]:.3f} ms (profiler; the FMA design: "
              f"{FMA_DESIGN_MS[name]} ms), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
              f"{100 * bound['bound_ms'] / split[kernel]:.1f} % of the bound; library (the whole "
              f"aten backward) {lib_ms:.3f} ms")
        if not split[kernel] * 3 <= fma:
            raise AssertionError(f"{kernel} {split[kernel]:.3f} ms is not 3x faster than the FMA "
                                 f"design's {fma} ms")
        errs_of = (errs["dq"],) if name == "dq" else (errs["dk"], errs["dv"])
        out[f"flash_bwd_{name}"] = {"max_abs_err": max(errs_of), "ms": split[kernel],
                                    "plain_ms": pms, "library_ms": lib_ms, **bound}
    print(f"[bwd] bf16 backward {ms:.3f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s): dq kernel "
          f"{split['dq_mma_kernel']:.3f} ms, dk/dv kernel {split['dkdv_mma_kernel']:.3f} ms "
          f"(profiler); plain backward {pms:.3f} ms")
    return out


def phase_bias(torch):
    """The bias path through `flash_attn_func` at the training shape: a
    trainable per-head bias [1, 32, S, S] (ALiBi-style), bf16."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    S, D = BWD_SEQ, 128
    q32, k32, v32, do32, lens = attn_inputs(torch, gen, dev, S)
    b32 = torch.randn((1, 32, S, S), generator=gen, device=dev)
    leaves = [x.to(torch.bfloat16).requires_grad_() for x in (q32, k32, v32, b32)]
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves[:3], attention_bias=leaves[3], causal=True, return_lse=True)
    out.backward(do32.to(torch.bfloat16))
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    print(f"[bias] flash_attn_func + backward with a trainable [1, 32, {S}, {S}] bias: launches {launches}")
    if any(n != 1 for n in launches.values()):
        raise AssertionError(f"the bias path did not launch every kernel once: {launches}")

    bhsd = lambda x: x.transpose(1, 2)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    q, k, v, b = (x.detach() for x in leaves)
    do = do32.to(torch.bfloat16)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(bhsd(q32), bhsd(k32), bhsd(v32), lens, 0, 0, b32, **kw)
    o_pl, _ = flash_fwd.flash_attn_forward_plain(bhsd(q), bhsd(k), bhsd(v), lens, 0, 0, b, **kw)
    out_err, pl_err = max_abs(torch, bhsd(out), o32), max_abs(torch, o_pl, o32)
    if not out_err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
        raise AssertionError(f"bias forward: err {out_err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
    refs = flash_bwd.flash_attn_backward_plain(
        bhsd(q32), bhsd(k32), bhsd(v32), bhsd(do32), o32, lse32, lens, 0, 0, b32,
        compute_dbias=True, **kw)
    plains = flash_bwd.flash_attn_backward_plain(
        bhsd(q), bhsd(k), bhsd(v), bhsd(do), bhsd(out.detach()), lse.detach(), lens, 0, 0, b,
        compute_dbias=True, **kw)
    grads = [bhsd(x.grad) for x in leaves[:3]] + [leaves[3].grad]
    errs = {}
    for n, g, r, pl in zip(("dq", "dk", "dv", "dbias"), grads, refs, plains):
        errs[n], _ = check_grad(torch, n, g, r, pl, "bias path")
    print(f"[bias] out err {out_err:.3e} (<= 2 x plain {pl_err:.3e} + 5e-5); grad errs vs fp32 "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (FA gradient contract)")
    args = (bhsd(q), bhsd(k), bhsd(v), bhsd(do), bhsd(out.detach()), lse.detach(), lens, 0, 0, b)
    run = lambda: flash_bwd.flash_attn_backward(*args, compute_dbias=True, **kw)
    split = kernel_ms(torch, run, ("dbias_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel"))
    pms = cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(*args, compute_dbias=True, **kw),
                  iters=3, warmup=1)
    extra = {"library_ms": None, **dbias_bound(2, 32, 8, S, D)}
    share = check_dbias_ms(split["dbias_mma_kernel"], extra, "dbias", "bias")
    print(f"[bias] plain backward with dbias {pms:.3f} ms; library: none (no PyTorch call "
          f"computes a bias gradient alone); the dq and dk/dv kernels' bias instantiations "
          f"{split['dq_mma_kernel']:.3f} + {split['dkdv_mma_kernel']:.3f} ms")
    return launches, {"max_abs_err": errs["dbias"], "ms": split["dbias_mma_kernel"],
                      "plain_ms": pms, "bound_share_pct": share,
                      "pair_bias_ms": [split["dq_mma_kernel"], split["dkdv_mma_kernel"]], **extra}


def phase_train_grads(torch):
    """Mistral-7B-v0.3 widths, 2 layers, bf16: every parameter gradient of
    loss_fn through the kernels and through the plain attention (the fp32
    oracle, output in bf16), both held to an fp32 plain run."""
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import LlamaModel, init_params, loss_fn
    from fa2_triton_tpu_torch.ops import flash_attn_reference, flash_bwd, flash_fwd

    cfg = preset_config("mistral-7b-v0.3", torch.bfloat16, n_layers=2)
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, TRAIN_SEQ))).cuda()

    def plain_attn(q, k, v):
        return flash_attn_reference(q, k, v, causal=True, softmax_scale=cfg.scale)

    def grads_of(m, attention_fn=None):
        m.zero_grad(set_to_none=True)
        loss = loss_fn(m, tokens, attention_fn)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), grads

    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    loss_k, g_k = grads_of(model)
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    if launches != {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkdv": 2, "flash_bwd_dbias": 0}:
        raise AssertionError(f"2-layer loss_fn backward launches {launches}")
    loss_p, g_p = grads_of(model, plain_attn)
    m32 = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    m32.load_state_dict(model.state_dict())
    del model
    loss_32, g_32 = grads_of(m32, plain_attn)
    del m32
    worst, worst_name = 0.0, None
    for name in g_32:
        err, yard = check_grad(torch, name, g_k[name], g_32[name], g_p[name], "2-layer grads")
        ratio = err / (GRAD_ERROR_MUL * yard + GRAD_ERROR_BIAS)
        if ratio >= worst:
            worst, worst_name = ratio, name
    print(f"[train] Mistral-7B-v0.3 widths, 2 layers, bf16, batch 2 x {TRAIN_SEQ}: loss kernels "
          f"{loss_k:.5f}, plain {loss_p:.5f}, fp32 {loss_32:.5f}; all {len(g_32)} parameter "
          f"gradients within the FA contract vs fp32 (worst {worst_name}: {worst:.2f} of the bound); "
          f"launches {launches}")


def run_trainer(torch, card: str, argv, reset, tag: str):
    """Full-depth training steps through `examples/train.py` with the launch
    counts reset (`reset`) after its warm-up: every loss finite and the last
    below the first. Returns (the parsed args, train.run's result)."""
    from fa2_triton_tpu_torch.examples import train

    args = train.parse_args(argv)
    res = train.run(args, on_warm=reset)
    cfg, losses = res["config"], res["losses"]
    print(f"[{tag}] {args.config} widths, {cfg.n_layers} layers, {res['n_params'] / 1e9:.2f} B "
          f"params bf16, remat, AdamW(lr {args.lr}, wd 0.01) + clip {args.grad_clip}, {args.steps} "
          f"steps of {args.batch} x {args.seq} on one repeated batch: losses "
          f"{[round(x, 4) for x in losses]}; step s {[round(x, 3) for x in res['step_s']]}, "
          f"{res['tokens_per_s']:.0f} tokens/s (median step), peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite or not falling: {losses}")
    return args, res


def phase_train(torch, card: str):
    """Full-depth training steps through `examples/train.py`."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    def reset():
        flash_fwd.LAUNCHES = 0
        flash_bwd.reset_launches()

    args, res = run_trainer(torch, card, TRAIN_ARGV, reset, "train")
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    L, steps = res["config"].n_layers, args.steps
    print(f"[train] launches: {launches}")
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want} (layers x steps, x2 for remat)")
    return launches


def varlen_docs():
    """Document lengths of the packed batch (see VARLEN_DOC_RANGE)."""
    rng = np.random.default_rng(0)
    lens, T = [], 0
    while True:
        n = int(np.exp(rng.uniform(*np.log(VARLEN_DOC_RANGE))))
        ext = -(-n // VARLEN_BLOCK) * VARLEN_BLOCK
        if T + ext > VARLEN_T_MAX:
            return lens
        lens.append(n)
        T += ext


def blocksparse_mask():
    """Block (i, j) is kept when i - BS_BAND <= j <= i, or j = 0."""
    n = BS_SEQ // VARLEN_BLOCK
    i, j = np.arange(n)[:, None], np.arange(n)[None]
    return ((j >= i - BS_BAND) & (j <= i)) | (j == 0)


def check_packed_path(torch, what, inputs, grads, out, lse, do32, packed32, seg, keep_block, live,
                      **drop):
    """The kernels' output, lse and gradients of one packed run against the
    plain twins: the fp32 truth and the bf16 plain yardstick (FA rules),
    and exact zeros at the dead positions. The bf16 `inputs` (q, k, v),
    their `grads`, `out` and the fp32 `packed32` / `do32` are [1, T, H, D],
    lse [1, Hq, T]; `seg` is (starts, lens); `drop` the dropout arguments
    of the run. Returns the errors, the fp32 output and the fp32 gradients."""
    from fa2_triton_tpu_torch.ops import varlen

    bhsd = lambda x: x.transpose(1, 2)
    pkw = dict(causal=True, softmax_scale=inputs[0].shape[-1] ** -0.5, block_q=VARLEN_BLOCK,
               block_kv=VARLEN_BLOCK, keep_block=keep_block, **drop)
    args = (seg[0], seg[1], seg[1])
    with torch.no_grad():
        q32, k32, v32 = (bhsd(x) for x in packed32)
        o32, lse32 = varlen.flash_attn_varlen_forward_plain(q32, k32, v32, *args, **pkw)
        refs = varlen.flash_attn_varlen_backward_plain(q32, k32, v32, bhsd(do32), o32, lse32,
                                                       *args, **pkw)
        del q32, k32, v32
        q, k, v, do = (bhsd(x) for x in (*inputs, do32.to(torch.bfloat16)))
        o_pl, lse_pl = varlen.flash_attn_varlen_forward_plain(q, k, v, *args, **pkw)
        plains = varlen.flash_attn_varlen_backward_plain(q, k, v, do, o_pl, lse_pl, *args, **pkw)
    err, pl_err = max_abs(torch, bhsd(out), o32), max_abs(torch, o_pl, o32)
    if not err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
        raise AssertionError(f"{what} forward: err {err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
    lse_err = check_lse(torch, lse, lse_pl, what)
    errs = {"o": err, "o plain": pl_err, "lse": lse_err}
    for n, g, r, pl in zip(("dq", "dk", "dv"), (bhsd(x) for x in grads), refs, plains):
        errs[n], errs[n + " plain"] = check_grad(torch, n, g, r, pl, what)
    dead = ~live
    if out[0, dead].any() or not torch.all(lse[0][:, dead] == float("-inf")):
        raise AssertionError(f"{what}: dead positions hold a nonzero output or a finite lse")
    if any(g[0, dead].any() for g in grads):
        raise AssertionError(f"{what}: dead positions hold a nonzero gradient")
    print(f"[{what}] max abs errs vs fp32 plain: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + " (FA rules; lse vs the bf16 plain twin); dead positions exactly 0")
    return errs, o32, refs


# The packed kernels' names in the profiler for bf16 inputs: the tensor-core
# forward, dq and dk/dv (fp32 inputs keep the FMA varlen_fwd_kernel /
# varlen_dq_kernel / varlen_dkdv_kernel).
VARLEN_KERNEL_NAMES = {"varlen_fwd": "varlen_mma_fwd_kernel", "varlen_dq": "varlen_mma_dq_kernel",
                       "varlen_dkdv": "varlen_mma_dkdv_kernel"}


def time_packed_kernels(torch, inputs, do, seg, keep_block, **drop):
    """Device time of each varlen kernel (profiler, keyed by the names of
    VARLEN_KERNEL_NAMES), the whole wrapper calls (CUDA events, host work
    lists included) and the plain twins, bf16."""
    from fa2_triton_tpu_torch.ops import varlen

    bhsd = lambda x: x.transpose(1, 2)
    pkw = dict(causal=True, softmax_scale=inputs[0].shape[-1] ** -0.5, block_q=VARLEN_BLOCK,
               block_kv=VARLEN_BLOCK, keep_block=keep_block, **drop)
    args = (seg[0], seg[1], seg[1])
    q, k, v, do = (bhsd(x) for x in (*inputs, do))
    with torch.no_grad():
        o, lse = varlen.flash_attn_varlen_forward(q, k, v, *args, **pkw)
        fwd = lambda: varlen.flash_attn_varlen_forward(q, k, v, *args, **pkw)
        bwd = lambda: varlen.flash_attn_varlen_backward(q, k, v, do, o, lse, *args, **pkw)
        t = kernel_ms(torch, fwd, (VARLEN_KERNEL_NAMES["varlen_fwd"],))
        t.update(kernel_ms(torch, bwd, (VARLEN_KERNEL_NAMES["varlen_dq"],
                                        VARLEN_KERNEL_NAMES["varlen_dkdv"])))
        t["fwd call"], t["bwd call"] = cuda_ms(torch, fwd, iters=5), cuda_ms(torch, bwd, iters=5)
        t["plain fwd"] = cuda_ms(torch, lambda: varlen.flash_attn_varlen_forward_plain(
            q, k, v, *args, **pkw), iters=2, warmup=1)
        t["plain bwd"] = cuda_ms(torch, lambda: varlen.flash_attn_varlen_backward_plain(
            q, k, v, do, o, lse, *args, **pkw), iters=2, warmup=1)
    return t


def varlen_entries(t, errs, lib, pairs, tokens):
    """The kernels-line entries of the three varlen kernels, each with its
    share of the bound and its time over the library's (the whole backward
    for dq and dk/dv)."""
    b = lambda kernel: attn_bound(kernel, pairs, tokens, 32, 8, 128, 2)
    out = {
        "varlen_fwd": {"max_abs_err": errs["o"], "plain_ms": t["plain fwd"],
                       "library_ms": lib["fwd"], **b("fwd")},
        "varlen_dq": {"max_abs_err": errs["dq"], "plain_ms": t["plain bwd"],
                      "library_ms": lib["bwd"], **b("dq")},
        "varlen_dkdv": {"max_abs_err": max(errs["dk"], errs["dv"]), "plain_ms": t["plain bwd"],
                        "library_ms": lib["bwd"], **b("dkdv")},
    }
    for name, e in out.items():
        e["ms"] = ms = t[VARLEN_KERNEL_NAMES[name]]
        e["kernel"] = VARLEN_KERNEL_NAMES[name]
        e["bound_share"] = e["bound_ms"] / ms
        e["over_library"] = ms / e["library_ms"]
    return out


def print_packed_times(what, t, lib, entries):
    bwd = entries["varlen_dq"]["ms"] + entries["varlen_dkdv"]["ms"]
    print(f"[{what}] bf16 kernels (profiler): " + ", ".join(
        f"{e['kernel']} {e['ms']:.3f} ms (bound {e['bound_ms']:.3f} ms, {e['bound_by']}: "
        f"{100 * e['bound_share']:.1f} % of it; {e['over_library']:.2f}x the library)"
        for e in entries.values())
        + f"; dq + dk/dv {bwd:.3f} ms = {bwd / lib['bwd']:.2f}x the library's whole backward"
        + f"; whole calls (CUDA events, host work lists included): forward {t['fwd call']:.3f} ms, "
          f"backward {t['bwd call']:.3f} ms; plain forward {t['plain fwd']:.3f} ms, plain backward "
          f"{t['plain bwd']:.3f} ms; library ({lib['name']}) forward {lib['fwd']:.3f} ms, "
          f"backward {lib['bwd']:.3f} ms")


def beats_packed_fma(what, entries):
    """Fail unless the packed tensor-core kernels (forward, dq, dk/dv) are
    VARLEN_SPEEDUP times faster than their FMA design at this phase's shape
    (the log line gives both)."""
    for name in VARLEN_KERNEL_NAMES:
        key = f"{what}_{name.split('_')[1]}"
        print(f"[{what}] {VARLEN_KERNEL_NAMES[name]}: {entries[name]['ms']:.3f} ms (the FMA design: "
              f"{FMA_DESIGN_MS[key]} ms, to beat {VARLEN_SPEEDUP}x)")
        beats_fma_design(key, [entries[name]["ms"]], by=VARLEN_SPEEDUP)


def launch_table_ms(torch, starts, lens, T, Hq, Hkv, reps=3):
    """Host ms of the packed layout's q-major launch table (the forward's,
    which dq takes) and of the kv-major one (dk/dv's), each built `reps`
    times: `_build_schedule`, the row pointer, `_tile_order` and the copy
    to the card, synchronized."""
    from fa2_triton_tpu_torch.ops import varlen

    blk, dev = VARLEN_BLOCK, torch.device("cuda")
    segs = varlen._segments(starts, T, lens, lens, blk, blk)
    out = {}
    for name, kv_major in (("q-major", False), ("kv-major", True)):
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            varlen._launch_table(segs, blk, blk, True, None, T, dev, kv_major=kv_major,
                                 group=Hq // Hkv if kv_major else 1, order=True)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out[name] = runs
    return out


def phase_varlen(torch, card: str):
    """Packed varlen at Mistral-7B-v0.3 attention widths: the documents of
    `varlen_docs` packed with `pack_padded_batch`, forward and backward
    through `flash_attn_varlen_func` (launch counts reset just before),
    checked, timed, and compared with the same documents right-padded to
    [n_docs, 4096] through `flash_attn_func(attention_mask=...)`."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, varlen

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    lens = varlen_docs()
    n, S_pad, Hq, Hkv, D, blk = len(lens), VARLEN_DOC_RANGE[1], 32, 8, 128, VARLEN_BLOCK
    padded = [torch.randn((n, S_pad, h, D), generator=gen, device=dev) * sd
              for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    packed32, starts, T = varlen.pack_padded_batch(padded, lens, align=blk)
    starts = [int(s) for s in starts]
    cu = starts + [T]
    live = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, l in zip(starts, lens):
        live[s0:s0 + l] = True
    bf = lambda x: x.to(torch.bfloat16)
    leaves = [bf(x).requires_grad_() for x in packed32[:3]]
    do = bf(packed32[3])
    print(f"[varlen] {n} documents, lengths {lens} (log-uniform in {VARLEN_DOC_RANGE}, seed 0): "
          f"{sum(lens)} tokens packed into T = {T} (starts aligned to {blk}); Hq {Hq}, Hkv {Hkv}, "
          f"D {D}, bf16, causal, block_q = block_kv = {blk}")

    varlen.reset_launches()
    out, lse = varlen.flash_attn_varlen_func(*leaves, cu, seqlens=lens, causal=True, block_q=blk,
                                             block_kv=blk, return_lse=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(varlen.LAUNCHES)
    print(f"[varlen] flash_attn_varlen_func + backward: launches {launches}")
    if launches != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"the packed path did not launch each varlen kernel once: {launches}")
    inputs = [x.detach() for x in leaves]
    errs, o32, refs = check_packed_path(torch, "varlen", inputs, [x.grad for x in leaves], out, lse,
                                        packed32[3], packed32[:3], (starts, lens), None, live)
    del out, lse
    t = time_packed_kernels(torch, inputs, do, (starts, lens), None)

    # Library yardstick: PyTorch's varlen flash attention on the same
    # documents packed back to back.
    tq, tk, tv, tdo = (tight(torch, bf(x), lens) for x in padded)
    lib_fwd, lib_out, lib_bwd = library_attention(torch, tq, tk, tv, lens, lens, True, D ** -0.5)
    live_rows = lambda x: x.transpose(1, 2)[0][live]      # [1, H, T, D] -> [sum(lens), H, D]
    check_library(torch, "varlen fwd", lib_out[0], live_rows(o32), errs["o plain"])
    lib_run = lib_bwd(tdo)
    for name, g, r in zip(("dq", "dk", "dv"), lib_run(), refs):
        check_library(torch, f"varlen {name}", g, live_rows(r), errs[name + " plain"])
    lib = {"name": "aten varlen flash attention", "fwd": cuda_ms(torch, lib_fwd),
           "bwd": cuda_ms(torch, lib_run, iters=5)}
    del tq, tk, tv, tdo, lib_out, o32, refs
    entries = varlen_entries(t, errs, lib, causal_pairs(lens), sum(lens))
    print_packed_times("varlen", t, lib, entries)
    beats_packed_fma("varlen", entries)
    tables = launch_table_ms(torch, starts, lens, T, Hq, Hkv)
    print(f"[varlen] host launch tables (host clock, 3 builds each): q-major (the forward's, "
          f"which dq takes) {' / '.join(f'{x:.3f}' for x in tables['q-major'])} ms, kv-major "
          f"(dk/dv's, built in the backward) {' / '.join(f'{x:.3f}' for x in tables['kv-major'])} ms")
    entries["varlen_fwd"]["host_table_ms"] = tables["q-major"]
    entries["varlen_dkdv"]["host_table_ms"] = tables["kv-major"]

    # The same documents right-padded to [n_docs, S_pad] through the dense
    # kernels with a padding mask: what packing saves (bench.py --mode varlen).
    mask = torch.arange(S_pad, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
    pad_leaves = [bf(x).requires_grad_() for x in padded[:3]]
    pad_do = bf(padded[3])
    del padded

    def padded_step():
        o = flash_attn_func(*pad_leaves, attention_mask=mask, causal=True)
        torch.autograd.grad(o, pad_leaves, pad_do)

    def packed_step():
        o = varlen.flash_attn_varlen_func(*leaves, cu, seqlens=lens, causal=True, block_q=blk,
                                          block_kv=blk)
        torch.autograd.grad(o, leaves, do)

    pad_ms, pack_ms = cuda_ms(torch, padded_step, iters=3), cuda_ms(torch, packed_step, iters=3)
    pad_ms2, pack_ms2 = cuda_ms(torch, padded_step, iters=3), cuda_ms(torch, packed_step, iters=3)
    print(f"[varlen] forward + backward, bf16 [{card}]: packed (T = {T}) {pack_ms:.3f} / "
          f"{pack_ms2:.3f} ms vs right-padded [{n}, {S_pad}] through flash_attn_func "
          f"{pad_ms:.3f} / {pad_ms2:.3f} ms: padded / packed = {pad_ms / pack_ms:.2f} / "
          f"{pad_ms2 / pack_ms2:.2f}")
    return launches, entries


def phase_blocksparse(torch):
    """Block-sparse attention at Mistral-7B-v0.3 attention widths: a local
    band plus an attention sink, through `flash_attn_blocksparse_func`
    (launch counts reset just before), checked and timed like phase_varlen;
    the library yardstick is flex_attention (compiled) with the same
    block mask."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from fa2_triton_tpu_torch.ops import varlen

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S, Hq, Hkv, D, blk = BS_BATCH, BS_SEQ, 32, 8, 128, VARLEN_BLOCK
    mask = blocksparse_mask()
    x32 = [torch.randn((B, S, h, D), generator=gen, device=dev) * sd
           for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    bf = lambda x: x.to(torch.bfloat16)
    leaves = [bf(x).requires_grad_() for x in x32[:3]]
    do = bf(x32[3])
    n_kept = int(np.tril(mask).sum())
    print(f"[blocksparse] B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, causal, block {blk}: "
          f"band of {BS_BAND} blocks below the diagonal + column 0, {n_kept} of "
          f"{mask.shape[0] * (mask.shape[0] + 1) // 2} causal blocks kept")

    varlen.reset_launches()
    out, lse = varlen.flash_attn_blocksparse_func(*leaves, mask, causal=True, block_q=blk,
                                                  block_kv=blk, return_lse=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(varlen.LAUNCHES)
    print(f"[blocksparse] flash_attn_blocksparse_func + backward: launches {launches}")
    if launches != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"the block-sparse path did not launch each kernel once: {launches}")

    # The packed view the entry point hands the kernels: [1, B * S, H, D].
    flat = lambda x: x.reshape(1, B * S, *x.shape[2:])
    seg = ([b * S for b in range(B)], [S] * B)
    keep = varlen._mask_keep_fn(varlen.encode_block_mask(mask))
    inputs = [flat(x.detach()) for x in leaves]
    lse_packed = lse.transpose(0, 1).reshape(1, Hq, B * S)
    errs, o32, refs = check_packed_path(
        torch, "blocksparse", inputs, [flat(x.grad) for x in leaves], flat(out), lse_packed,
        flat(x32[3]), [flat(x) for x in x32[:3]], seg, keep,
        torch.ones(B * S, dtype=torch.bool, device=dev))
    del out, lse
    t = time_packed_kernels(torch, inputs, flat(do), seg, keep)

    def mask_mod(b, h, qi, ki):
        return (ki <= qi) & ((qi // blk - ki // blk <= BS_BAND) | (ki < blk))

    block_mask = create_block_mask(mask_mod, None, None, S, S, device=dev, BLOCK_SIZE=blk)
    flex = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in leaves)
    doh = do.transpose(1, 2).contiguous()
    t0 = time.perf_counter()
    lib_o = flex(qh, kh, vh, block_mask=block_mask, scale=D ** -0.5, enable_gqa=True)
    lib_grads = torch.autograd.grad(lib_o, (qh, kh, vh), doh, retain_graph=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    bhsd_flat = lambda x: x.transpose(1, 2).reshape(1, B * S, *x.shape[1:2], D).transpose(1, 2)
    check_library(torch, "blocksparse fwd", bhsd_flat(lib_o), o32, errs["o plain"])
    for name, g, r in zip(("dq", "dk", "dv"), lib_grads, refs):
        check_library(torch, f"blocksparse {name}", bhsd_flat(g), r, errs[name + " plain"])
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(torch, lambda: flex(qh, kh, vh, block_mask=block_mask,
                                                 scale=D ** -0.5, enable_gqa=True), iters=5)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(lib_o, (qh, kh, vh), doh,
                                                            retain_graph=True), iters=5)
    lib = {"name": f"flex_attention with the block mask, compiled in {compile_s:.1f} s",
           "fwd": lib_fwd_ms, "bwd": lib_bwd_ms}
    pairs = B * sum(blk * blk if j < i else blk * (blk + 1) // 2
                    for i in range(mask.shape[0]) for j in range(i + 1) if mask[i, j])
    entries = varlen_entries(t, errs, lib, pairs, B * S)
    print_packed_times("blocksparse", t, lib, entries)
    beats_packed_fma("blocksparse", entries)
    return launches, entries


# Phase 10: attention dropout at Mistral-7B-v0.3 attention widths (bf16).
DROPOUT_P = 0.1
DROPOUT_SEED = 1234567
# The drop share over the 2 x 32 x 2048^2 mask grid: the binomial sigma is
# sqrt(p (1 - p) / n) = 1.8e-5 at p = 0.1, so 1e-4 is ~5.5 sigma.
DROP_SHARE_TOL = 1e-4
# The dense probes sit at q_off 37 / kv_off 11 of sequences whose real
# lengths (the dropout counter's) are 4096.
PROBE_Q_OFF, PROBE_KV_OFF, PROBE_REAL = 37, 11, 4096
LAYER_STEPS = 3


def dropout_probes(torch, dev):
    """Every kernel's applied mask read by `utils/mask_probes.py`, held to
    the rng mask bit for bit, at D 64 / 128 / 256 and GQA groups 1 and 4."""
    from fa2_triton_tpu_torch.utils import mask_probes

    worst, bits = 0.0, 0
    for D in (64, 128, 256):
        for G in (1, 4):
            got = mask_probes.dense_probes(
                2, 8, 8 // G, D, DROPOUT_P, DROPOUT_SEED + D + G, device=dev, q_off=PROBE_Q_OFF,
                kv_off=PROBE_KV_OFF, seqlen_q_real=PROBE_REAL, seqlen_k_real=PROBE_REAL)
            got.update(mask_probes.packed_probes(8, 8 // G, D, DROPOUT_P, -DROPOUT_SEED - D - G,
                                                 device=dev))
            for name, (read, want, resid) in got.items():
                if not torch.equal(read, want):
                    raise AssertionError(f"dropout probe {name} D={D} G={G}: "
                                         f"{int((read != want).sum())} bits differ from the rng mask")
                if not resid <= mask_probes.RESIDUAL_TOL:
                    raise AssertionError(f"dropout probe {name} D={D} G={G}: residual {resid:.3e} > "
                                         f"{mask_probes.RESIDUAL_TOL} (the mask is right, its scale not)")
                worst, bits = max(worst, resid), bits + read.numel()
    print(f"[dropout] mask probes (fwd, dq, dk/dv, dbias at q_off {PROBE_Q_OFF} / kv_off "
          f"{PROBE_KV_OFF} of real lengths {PROBE_REAL}; varlen fwd, dq, dk/dv on 3 documents at "
          f"packed offsets; D 64/128/256 x GQA group 1/4; B 2, 8 q heads; bf16): {bits} bits equal "
          f"to utils/rng.py's mask, largest residual {worst:.2e} (tol {mask_probes.RESIDUAL_TOL})")


def dense_dropout(torch, card):
    """flash_attn_func(causal, dropout) forward + backward at B 2 x S 2048,
    32 / 8 heads, D 128, bf16: launches, errors against the fp32 oracle fed
    the same mask (FA rules, the bf16 plain twin as yardstick), the drop
    share, determinism in the seed, the bias path with dropout, and times
    with and without dropout."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_attn_reference, flash_bwd, flash_fwd
    from fa2_triton_tpu_torch.utils import dropout_keep_mask_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    S, D, Hq, Hkv, B = TRAIN_SEQ, 128, 32, 8, 2
    scale = D ** -0.5
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    q32, k32, v32, do32, lens = attn_inputs(torch, gen, dev, S)
    bf = lambda x: x.to(torch.bfloat16)
    bhsd = lambda x: x.transpose(1, 2)
    leaves = [bf(x).requires_grad_() for x in (q32, k32, v32)]
    do = bf(do32)
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves, causal=True, return_lse=True, **drop)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    print(f"[dropout] flash_attn_func(causal, dropout_p {DROPOUT_P}, seed {DROPOUT_SEED}) + backward, "
          f"B {B} x S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16: launches {launches}")
    if launches != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}:
        raise AssertionError(f"the dropout path did not launch each kernel once: {launches}")

    keep = dropout_keep_mask_reference(DROPOUT_SEED, DROPOUT_P, B, Hq, S, S, device=dev)
    share = 1.0 - float(keep.float().mean())
    print(f"[dropout] drop share over the {keep.numel()} elements of the mask grid: {share:.7f} "
          f"(p {DROPOUT_P}, tol {DROP_SHARE_TOL})")
    if not abs(share - DROPOUT_P) <= DROP_SHARE_TOL:
        raise AssertionError(f"drop share {share} is not within {DROP_SHARE_TOL} of p")
    ref_leaves = [x.clone().requires_grad_() for x in (q32, k32, v32)]
    o_ref = flash_attn_reference(*ref_leaves, causal=True, dropout_p=DROPOUT_P, dropout_mask=keep)
    o_ref.backward(do32)
    refs = [x.grad for x in ref_leaves]
    del keep, ref_leaves
    kw = dict(causal=True, softmax_scale=scale, **drop)
    q, k, v = (bhsd(x.detach()) for x in leaves)
    with torch.no_grad():
        o_pl, _ = flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw)
        plains = flash_bwd.flash_attn_backward_plain(q, k, v, bhsd(do), bhsd(out.detach()),
                                                     lse.detach(), lens, **kw)
    out_err, pl_err = max_abs(torch, out, o_ref), max_abs(torch, bhsd(o_pl), o_ref)
    if not out_err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
        raise AssertionError(f"dropout forward: err {out_err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
    errs = {"o": out_err, "o plain": pl_err}
    for n, x, r, pl in zip(("dq", "dk", "dv"), leaves, refs, plains):
        errs[n], errs[n + " plain"] = check_grad(torch, n, x.grad, r, bhsd(pl), "dropout")
    print("[dropout] errors vs the fp32 oracle (flash_attn_reference, dropout_mask = the rng mask): "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (FA rules)")
    del o_ref, refs, plains, o_pl

    def run(seed):
        ls = [x.detach().requires_grad_() for x in leaves]
        o = flash_attn_func(*ls, causal=True, dropout_p=DROPOUT_P, dropout_seed=seed)
        o.backward(do)
        return [o.detach()] + [x.grad for x in ls]

    first = [out.detach()] + [x.grad for x in leaves]
    again, other = run(DROPOUT_SEED), run(DROPOUT_SEED + 1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("dropout: the same seed gave different o / dq / dk / dv")
    if any(torch.equal(a, b) for a, b in zip(first, other)):
        raise AssertionError("dropout: seed + 1 left o, dq, dk or dv unchanged")
    print("[dropout] the same seed gives bitwise-equal o, dq, dk, dv; seed + 1 changes each")
    del again, other

    # Times: no dropout, dropout, dropout, no dropout, in turns.
    with torch.no_grad():
        o_nd, lse_nd = flash_fwd.flash_attn_forward(q, k, v, lens, causal=True, softmax_scale=scale)
        o_d, lse_d = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
        fwd = {False: lambda: flash_fwd.flash_attn_forward(q, k, v, lens, causal=True,
                                                           softmax_scale=scale),
               True: lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw)}
        bwd = {False: lambda: flash_bwd.flash_attn_backward(q, k, v, bhsd(do), o_nd, lse_nd, lens,
                                                            causal=True, softmax_scale=scale),
               True: lambda: flash_bwd.flash_attn_backward(q, k, v, bhsd(do), o_d, lse_d, lens, **kw)}
        t = {False: [], True: []}
        for d in (False, True, True, False):
            t[d].append({"fwd": cuda_ms(torch, fwd[d]),
                         **kernel_ms(torch, bwd[d], ("dq_mma_kernel", "dkdv_mma_kernel"))})
        plain_fwd = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw),
                            iters=2, warmup=1)
        plain_bwd = cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(
            q, k, v, bhsd(do), o_d, lse_d, lens, **kw), iters=2, warmup=1)
    seq = [S, S]
    lib = {}
    for name, dp in (("no dropout", 0.0), ("dropout", DROPOUT_P)):
        lib_fwd, _, lib_bwd = library_attention(torch, *(tight(torch, bhsd(x), seq) for x in (q, k, v)),
                                                seq, seq, True, scale, dropout_p=dp)
        lib[name] = (cuda_ms(torch, lib_fwd), cuda_ms(torch, lib_bwd(tight(torch, do, seq)), iters=5))
    pairs = causal_pairs(seq)
    mean = lambda d, n: sum(x[n] for x in t[d]) / len(t[d])
    for n, label in (("fwd", "forward"), ("dq_mma_kernel", "dq"), ("dkdv_mma_kernel", "dk/dv")):
        print(f"[dropout] {label} kernel at S {S} [{card}]: no dropout "
              f"{' / '.join(f'{x[n]:.3f}' for x in t[False])} ms, dropout "
              f"{' / '.join(f'{x[n]:.3f}' for x in t[True])} ms "
              f"({100 * (mean(True, n) / mean(False, n) - 1):+.1f} %)")
    print(f"[dropout] plain twins with dropout: forward {plain_fwd:.3f} ms, backward {plain_bwd:.3f} ms; "
          f"library (aten varlen flash, its own Philox mask): forward {lib['no dropout'][0]:.3f} ms "
          f"-> {lib['dropout'][0]:.3f} ms with dropout, backward {lib['no dropout'][1]:.3f} -> "
          f"{lib['dropout'][1]:.3f} ms")
    entries = {}
    for name, n, kernel, err in (("flash_fwd_dropout", "fwd", "fwd", errs["o"]),
                                 ("flash_bwd_dropout_dq", "dq_mma_kernel", "dq", errs["dq"]),
                                 ("flash_bwd_dropout_dkdv", "dkdv_mma_kernel", "dkdv",
                                  max(errs["dk"], errs["dv"]))):
        entries[name] = {
            "max_abs_err": err, "ms": t[True][0][n], "ms_runs": [x[n] for x in t[True]],
            "ms_without_dropout": [x[n] for x in t[False]],
            "plain_ms": plain_fwd if n == "fwd" else plain_bwd,
            "library_ms": lib["dropout"][0 if n == "fwd" else 1],
            **attn_bound(kernel, pairs, 2 * S, Hq, Hkv, D, 2)}
    del q, k, v, o_nd, o_d, lse_nd, lse_d, first, out, lse

    # The bias path with dropout: the dbias kernel regenerates the mask.
    b32 = torch.randn((1, Hq, S, S), generator=gen, device=dev)
    leaves = [bf(x).requires_grad_() for x in (q32, k32, v32, b32)]
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves[:3], attention_bias=leaves[3], causal=True, return_lse=True,
                               **drop)
    out.backward(do)
    torch.cuda.synchronize()
    bias_launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    if any(n != 1 for n in bias_launches.values()):
        raise AssertionError(f"the bias + dropout path did not launch every kernel once: {bias_launches}")
    with torch.no_grad():
        o32, lse32 = flash_fwd.flash_attn_forward_plain(bhsd(q32), bhsd(k32), bhsd(v32), lens, 0, 0,
                                                        b32, **kw)
        refs = flash_bwd.flash_attn_backward_plain(bhsd(q32), bhsd(k32), bhsd(v32), bhsd(do32), o32,
                                                   lse32, lens, 0, 0, b32, compute_dbias=True, **kw)
        del o32, lse32
        qb, kb, vb, bb = (x.detach() for x in leaves)
        args = (bhsd(qb), bhsd(kb), bhsd(vb), bhsd(do), bhsd(out.detach()), lse.detach(), lens, 0, 0, bb)
        plains = flash_bwd.flash_attn_backward_plain(*args, compute_dbias=True, **kw)
    grads = [bhsd(x.grad) for x in leaves[:3]] + [leaves[3].grad]
    berrs = {n: check_grad(torch, n, g, r, pl, "bias + dropout")[0]
             for n, g, r, pl in zip(("dq", "dk", "dv", "dbias"), grads, refs, plains)}
    del refs, plains, grads
    split = kernel_ms(torch, lambda: flash_bwd.flash_attn_backward(*args, compute_dbias=True, **kw),
                      ("dbias_mma_kernel",))
    print(f"[dropout] bias path (a trainable [1, {Hq}, {S}, {S}] bias) with dropout: launches "
          f"{bias_launches}; grad errs vs the fp32 plain twin " + ", ".join(
              f"{n} {e:.3e}" for n, e in berrs.items()) + " (FA gradient contract)")
    bound = dbias_bound(B, Hq, Hkv, S, D)
    share = check_dbias_ms(split["dbias_mma_kernel"], bound, "dbias_dropout", "dropout")
    entries["flash_bwd_dbias_dropout"] = {"max_abs_err": berrs["dbias"],
                                          "ms": split["dbias_mma_kernel"],
                                          "bound_share_pct": share, **bound}
    return {"flash_attn_func": launches, "bias path": bias_launches}, entries


def packed_dropout(torch, card):
    """Phase 8's packed batch through flash_attn_varlen_func with dropout:
    launches, FA rules against the plain twins with the same seed, dead
    positions exactly 0, times with and without dropout, and each
    tensor-core kernel VARLEN_SPEEDUP times faster than its FMA design with
    dropout."""
    from fa2_triton_tpu_torch.ops import varlen

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    lens = varlen_docs()
    n, S_pad, Hq, Hkv, D, blk = len(lens), VARLEN_DOC_RANGE[1], 32, 8, 128, VARLEN_BLOCK
    padded = [torch.randn((n, S_pad, h, D), generator=gen, device=dev) * sd
              for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    packed32, starts, T = varlen.pack_padded_batch(padded, lens, align=blk)
    starts = [int(s) for s in starts]
    live = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, l in zip(starts, lens):
        live[s0:s0 + l] = True
    bf = lambda x: x.to(torch.bfloat16)
    leaves = [bf(x).requires_grad_() for x in packed32[:3]]
    do = bf(packed32[3])
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    varlen.reset_launches()
    out, lse = varlen.flash_attn_varlen_func(*leaves, starts + [T], seqlens=lens, causal=True,
                                             block_q=blk, block_kv=blk, return_lse=True, **drop)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(varlen.LAUNCHES)
    print(f"[dropout varlen] phase 8's {n} documents (T = {T}) through flash_attn_varlen_func with "
          f"dropout: launches {launches}")
    if launches != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"the packed dropout path did not launch each kernel once: {launches}")
    inputs = [x.detach() for x in leaves]
    errs, _, _ = check_packed_path(torch, "dropout varlen", inputs, [x.grad for x in leaves], out,
                                   lse, packed32[3], packed32[:3], (starts, lens), None, live, **drop)
    del out, lse, packed32
    t_nd = time_packed_kernels(torch, inputs, do, (starts, lens), None)
    t_d = time_packed_kernels(torch, inputs, do, (starts, lens), None, **drop)
    t_d2 = time_packed_kernels(torch, inputs, do, (starts, lens), None, **drop)
    t_nd2 = time_packed_kernels(torch, inputs, do, (starts, lens), None)
    tq, tk, tv, tdo = (tight(torch, bf(x), lens) for x in padded)
    lib_fwd, _, lib_bwd = library_attention(torch, tq, tk, tv, lens, lens, True, D ** -0.5,
                                            dropout_p=DROPOUT_P)
    lib = {"name": "aten varlen flash attention with dropout (its own Philox mask)",
           "fwd": cuda_ms(torch, lib_fwd), "bwd": cuda_ms(torch, lib_bwd(tdo), iters=5)}
    del tq, tk, tv, tdo, padded
    entries = varlen_entries(t_d, errs, lib, causal_pairs(lens), sum(lens))
    for name, key in VARLEN_KERNEL_NAMES.items():
        entries[name]["ms_runs"] = [t_d[key], t_d2[key]]
        entries[name]["ms_without_dropout"] = [t_nd[key], t_nd2[key]]
        print(f"[dropout varlen] {name} [{card}]: no dropout {t_nd[key]:.3f} / {t_nd2[key]:.3f} ms, "
              f"dropout {t_d[key]:.3f} / {t_d2[key]:.3f} ms "
              f"({100 * ((t_d[key] + t_d2[key]) / (t_nd[key] + t_nd2[key]) - 1):+.1f} %)")
    print_packed_times("dropout varlen", t_d, lib, entries)
    beats_packed_fma("varlen_dropout", entries)
    return launches, {f"{k}_dropout": e for k, e in entries.items()}


def layer_dropout(torch, card):
    """`FlashSelfAttention` at Mistral-7B-v0.3 attention widths (4096 -> 32 /
    8 heads, head_dim 128, RoPE theta 1e6, causal, dropout 0.1; bf16 compute,
    fp32 params), B 2 x S 2048: LAYER_STEPS AdamW steps in training mode with
    the launch counts reset just before; eval equal to flash_attn_func
    without dropout bit for bit; one step's gradients equal under
    torch.utils.checkpoint bit for bit."""
    from torch.utils.checkpoint import checkpoint

    from fa2_triton_tpu_torch import FlashSelfAttention
    from fa2_triton_tpu_torch.models.llama import apply_rope, rope_cos_sin
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S, F = 2, TRAIN_SEQ, 4096
    torch.manual_seed(0)     # the layer's init and its per-call dropout seeds
    layer = FlashSelfAttention(F, 32, num_kv_heads=8, head_dim=128, causal=True,
                               dropout_p=DROPOUT_P, use_rope=True, rope_theta=1e6,
                               dtype=torch.bfloat16, dropout_rng=torch.default_generator, device=dev)
    opt = torch.optim.AdamW(layer.parameters(), lr=1e-4, weight_decay=0.01)
    x = torch.randn((B, S, F), generator=gen, device=dev).to(torch.bfloat16)
    target = torch.randn((B, S, F), generator=gen, device=dev)
    loss_of = lambda out: (out.float() - target).square().mean()
    layer.train()
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    losses, step_ms = [], []
    for _ in range(LAYER_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_of(layer(x))
        loss.backward()
        if not all(torch.isfinite(p.grad).all() for p in layer.parameters()):
            raise AssertionError("layer: a non-finite gradient")
        opt.step()
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    n_params = sum(p.numel() for p in layer.parameters())
    print(f"[dropout layer] FlashSelfAttention {F} -> 32 / 8 heads x 128, RoPE 1e6, causal, dropout "
          f"{DROPOUT_P}, bf16 compute / fp32 params ({n_params / 1e6:.1f} M), B {B} x S {S}, "
          f"{LAYER_STEPS} AdamW steps: losses {[round(v, 5) for v in losses]}, step ms "
          f"{[round(v, 2) for v in step_ms]} [{card}]; launches {launches}")
    want = {"flash_fwd": LAYER_STEPS, "flash_bwd_dq": LAYER_STEPS, "flash_bwd_dkdv": LAYER_STEPS,
            "flash_bwd_dbias": 0}
    if not np.isfinite(losses).all() or launches != want:
        raise AssertionError(f"layer steps: losses {losses}, launches {launches} != {want}")

    layer.eval()
    with torch.no_grad():
        got = layer(x)
        q, k, v = layer.q_proj(x), layer.k_proj(x), layer.v_proj(x)
        cos, sin = rope_cos_sin(torch.arange(S, device=dev), 128, 1e6)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        att = flash_attn_func(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, causal=True)
        want_out = layer.o_proj(att.reshape(B, S, F))
    if not torch.equal(got, want_out):
        raise AssertionError("layer eval differs from flash_attn_func without dropout")
    del got, want_out, q, k, v, att

    layer.train()

    def grads(remat):
        layer.zero_grad(set_to_none=True)
        torch.manual_seed(11)
        out = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        loss_of(out).backward()
        return [p.grad.clone() for p in layer.parameters()]

    plain, remat = grads(False), grads(True)
    if not all(torch.equal(a, b) for a, b in zip(plain, remat)):
        raise AssertionError("layer: gradients under checkpoint differ from those without it")
    print("[dropout layer] eval output equal to flash_attn_func without dropout bit for bit; one "
          "step's gradients under torch.utils.checkpoint equal to those without it bit for bit")
    return launches


def phase_dropout(torch, card):
    """Phase 10: the mask probes, the dense and packed dropout paths and the
    full-width FlashSelfAttention. Returns (launches by run, entries)."""
    t0 = time.perf_counter()
    dropout_probes(torch, torch.device("cuda"))
    runs, entries = dense_dropout(torch, card)
    torch.cuda.empty_cache()
    runs["varlen"], packed = packed_dropout(torch, card)
    entries.update(packed)
    torch.cuda.empty_cache()
    runs["layer"] = layer_dropout(torch, card)
    print(f"[dropout] phase 10 took {time.perf_counter() - t0:.1f} s")
    return runs, entries


# Phase 11: long-context causal schedules at Mistral-7B-v0.3 attention widths
# (32 / 8 heads, D 128, bf16, causal, no mask), B 1.
LONG_SEQ = 4096                  # the 1 x 4096 trainer feeds attention 4095 tokens: the split
STRIP_SEQ = 6144                 # the strip's default route (S 2049-3072 and 4097-7168)
SHIFT_SQ, SHIFT_SK = 2048, 4096  # a 2048-token chunk against a 4096-token context: the strip
LEAF = 2048                      # split_leaf_t(128, 2): the diag leaves at S 4096
LONG_TRAIN_ARGV = ["--config", "mistral-7b-v0.3", "--steps", "3", "--batch", "1",
                   "--seq", str(LONG_SEQ), "--remat", "--repeat-batch", "--lr", "3e-4",
                   "--grad-clip", "1.0"]


def sched_bound(pairs: int, rows: int, cols: int, extra_bytes: int = 0, Hq: int = 32,
                Hkv: int = 8, D: int = 128, elt: int = 2) -> dict:
    """Bound of a forward over `pairs` kept (query, key) pairs per q head (B
    1): 4 D operations per pair and head; q / o of `rows` rows, k / v of
    `cols` columns and the fp32 lse read or written once, + `extra_bytes`."""
    nbytes = 2 * rows * Hq * D * elt + 2 * cols * Hkv * D * elt + rows * Hq * 4 + extra_bytes
    return roofline(4 * D * pairs * Hq, nbytes)


def shifted_pairs(Sq: int, Sk: int) -> int:
    """Kept pairs of a bottom-right causal Sq x Sk problem (Sq <= Sk)."""
    return sum(Sk - Sq + i + 1 for i in range(Sq))


def hold_to_plain(torch, what, kernel, plain, x32, dtypes=None):
    """kernel(q, k, v) against plain(q, k, v), each -> (o, lse), on the BHSD
    views x32 cast to each dtype: fp32 within FP32_TOL of the plain twin,
    bf16 within 2 x the bf16 plain twin's error + 5e-5 of the fp32 truth;
    lse within LSE_TOL of the plain twin's, with its -inf pattern. Returns
    {"err", "plain_err"} at bf16 (at fp32 when only fp32 is asked)."""
    dtypes = dtypes or (torch.float32, torch.bfloat16)
    o_ref = plain(*x32)[0]
    res = {}
    for dt in dtypes:
        x = [t.to(dt) for t in x32]
        o, lse = kernel(*x)
        o_pl, lse_pl = plain(*x)
        torch.cuda.synchronize()
        lse_err = check_lse(torch, lse, lse_pl, f"{what} {dt}")
        if dt == torch.float32:
            pl_err, err = 0.0, max_abs(torch, o, o_pl)
            bound, rule = FP32_TOL, "vs the fp32 plain twin"
        else:
            pl_err, err = max_abs(torch, o_pl, o_ref), max_abs(torch, o, o_ref)
            bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
            rule = f"vs fp32 truth, <= 2 x plain bf16 err {pl_err:.3e} + 5e-5"
        print(f"[schedules] {what} {str(dt)[6:]}: max abs err {err:.3e} ({rule}), lse err "
              f"{lse_err:.3e}")
        if not err <= bound:
            raise AssertionError(f"{what} {dt}: err {err:.3e} > {bound:.3e}")
        res = {"err": err, "plain_err": pl_err}
        del x, o, lse, o_pl, lse_pl
    return res


def sched_launches(flash_fwd):
    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES}


def expect_launches(flash_fwd, what, run, **want):
    """Reset the counts, run, and require exactly `want` (0 for the rest)."""
    flash_fwd.reset_launches()
    out = run()
    got = sched_launches(flash_fwd)
    want = {n: want.get(n, 0) for n in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return out, got


def turns(torch, fns, order, iters=5):
    """CUDA-event ms of each named call, measured in the given order."""
    t = {name: [] for name in fns}
    for name in order:
        t[name].append(cuda_ms(torch, fns[name], iters=iters, warmup=1))
    return t


def schedule_kernels(torch, card):
    """Each schedule kernel held against its plain twin (fp32 and bf16, and
    fp32 with dropout fed the same mask), the strip against the generic
    kernel bit for bit, launches of each default route, and times: kernel,
    plain, library, the generic kernel at the same shape, bound."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from fa2_triton_tpu_torch.ops import flash_fwd as ff

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    Hq, Hkv, D = 32, 8, 128
    scale = D ** -0.5
    kw = dict(softmax_scale=scale)
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    bhsd = lambda x: x.transpose(1, 2)
    bf = lambda x: x.to(torch.bfloat16)

    def inputs(Sq, Sk):
        x = [bhsd(torch.randn((1, s, h, D), generator=gen, device=dev) * 0.5)
             for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]
        return x, torch.tensor([[Sq, Sk]], dtype=torch.int32, device=dev)

    def library(x, Sq, Sk, causal):
        fwd, out, _ = library_attention(torch, *(bhsd(t)[0].contiguous() for t in x), [Sq], [Sk],
                                        causal, scale)
        return fwd, out[0]

    entries = {}
    # -- the split at S 4095 and 4096: flash_attn_forward's default route ----
    for S in (LONG_SEQ - 1, LONG_SEQ):
        x32, lens = inputs(S, S)
        route = ff.forward_route(S, S, D, 2, causal=True, static_skip=True)
        if route != "split":
            raise AssertionError(f"S {S}: route {route}, not the split")
        split = lambda q, k, v, **d: ff.flash_attn_forward(q, k, v, lens, causal=True,
                                                           static_skip=True, **kw, **d)
        causal_plain = lambda q, k, v, **d: ff.flash_attn_forward_plain(q, k, v, lens, causal=True,
                                                                        **kw, **d)
        xb = [bf(t) for t in x32]
        _, got = expect_launches(ff, f"split S {S}", lambda: split(*xb), causal_diag=1,
                                 rect_merge=1)
        print(f"[schedules] flash_attn_forward(causal, static_skip) B 1 x S {S}, Hq {Hq}, Hkv {Hkv}, "
              f"D {D}, bf16: route {route}, launches {got}")
        split_err = hold_to_plain(torch, f"split S {S}", split, causal_plain, x32)
    # S 4096 from here on: the split against the generic kernel, and its two
    # launches (the diag, the rectangle merged into the diag's (o, lse)),
    # each timed on its own call by CUDA events: all three run flash_fwd.cu's
    # tensor-core kernel, under one name in a profile. Every split run must
    # beat its FMA design SPLIT_SPEEDUP times.
    generic = lambda q, k, v: ff.flash_attn_forward(q, k, v, lens, causal=True, **kw)
    diag = lambda q, k, v, **d: ff.flash_attn_forward_causal_diag(q, k, v, lens, T=LEAF, **kw, **d)
    region = dict(row0=LEAF, col0=0, nrows=LEAF, ncols=LEAF)
    prev = diag(*xb)
    t = turns(torch, {"generic": lambda: generic(*xb), "split": lambda: split(*xb),
                      "diag": lambda: diag(*xb),
                      "rect_merge": lambda: ff.flash_attn_forward_rect(*xb, lens, **region,
                                                                       merge_prev=prev, **kw)},
              ("generic", "split", "diag", "rect_merge", "rect_merge", "diag", "split", "generic"))
    split_over_generic = min(t["split"]) / min(t["generic"])
    print(f"[schedules] split S {S} bf16 [{card}]: "
          f"{' / '.join(f'{v:.3f}' for v in t['split'])} ms (the FMA design: "
          f"{FMA_DESIGN_MS['split_fwd']} ms, to beat {SPLIT_SPEEDUP}x): diag "
          f"{' / '.join(f'{v:.3f}' for v in t['diag'])} ms (FMA {FMA_DESIGN_MS['diag_fwd']}), "
          f"rect_merge {' / '.join(f'{v:.3f}' for v in t['rect_merge'])} ms (FMA "
          f"{FMA_DESIGN_MS['rect_merge_fwd']}); generic kernel "
          f"{' / '.join(f'{v:.3f}' for v in t['generic'])} ms; split / generic "
          f"{split_over_generic:.3f} (CUDA events, one call each)")
    beats_fma_design("split_fwd", t["split"], by=SPLIT_SPEEDUP)
    split_plain = cuda_ms(torch, lambda: causal_plain(*xb), iters=2, warmup=1)
    lib_fwd, lib_o = library(xb, S, S, True)
    o_ref = causal_plain(*x32)[0]
    check_library(torch, "split S 4096", lib_o, bhsd(o_ref)[0], split_err["plain_err"])
    split_lib = cuda_ms(torch, lib_fwd)
    split_bound = sched_bound(causal_pairs([S]), S, S)
    print(f"[schedules] split S {S} bf16: plain {split_plain:.3f} ms; library (aten flash, causal) "
          f"{split_lib:.3f} ms; bound {split_bound['bound_ms']:.3f} ms ({split_bound['bound_by']}): "
          f"{100 * split_bound['bound_ms'] / min(t['split']):.1f} % of the bound")
    del o_ref, lib_o

    # -- the diag leaves alone (T 2048 on the S 4096 inputs) -----------------
    diag_plain = lambda q, k, v, **d: ff.flash_attn_forward_causal_diag_plain(q, k, v, lens, T=LEAF,
                                                                              **kw, **d)
    diag_err = hold_to_plain(torch, f"diag T {LEAF}", diag, diag_plain, x32)
    diag_ms = min(t["diag"])
    diag_pms = cuda_ms(torch, lambda: diag_plain(*xb), iters=2, warmup=1)

    def leaf_mask(b, h, qi, ki):
        return (ki <= qi) & (qi // LEAF == ki // LEAF)

    block_mask = create_block_mask(leaf_mask, None, None, S, S, device=dev, BLOCK_SIZE=128)
    flex = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (t.contiguous() for t in xb)
    t0 = time.perf_counter()
    lib_o = flex(qh, kh, vh, block_mask=block_mask, scale=scale, enable_gqa=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    check_library(torch, "diag", lib_o, diag_plain(*x32)[0], diag_err["plain_err"])
    diag_lib = cuda_ms(torch, lambda: flex(qh, kh, vh, block_mask=block_mask, scale=scale,
                                           enable_gqa=True))
    diag_bound = sched_bound(causal_pairs([LEAF] * (S // LEAF)), S, S)
    print(f"[schedules] diag T {LEAF}, S {S} bf16 [{card}]: kernel {diag_ms:.3f} ms, plain "
          f"{diag_pms:.3f} ms, library (flex_attention, block-diagonal causal mask, compiled in "
          f"{compile_s:.1f} s) {diag_lib:.3f} ms, bound {diag_bound['bound_ms']:.4f} ms "
          f"({diag_bound['bound_by']})")
    entries["flash_fwd_causal_diag"] = {
        "max_abs_err": diag_err["err"], "ms": diag_ms, "plain_ms": diag_pms,
        "library_ms": diag_lib, **diag_bound,
        "split_S4096": {"max_abs_err": split_err["err"], "ms": min(t["split"]),
                        "ms_runs": t["split"], "generic_kernel_ms_runs": t["generic"],
                        "split_over_generic": split_over_generic, "diag_ms_runs": t["diag"],
                        "rect_merge_ms_runs": t["rect_merge"], "plain_ms": split_plain,
                        "library_ms": split_lib, "bound_ms": split_bound["bound_ms"]}}
    del lib_o, qh, kh, vh

    # -- the split with split_leaf 1024: four leaves, three rectangles -------
    split4 = lambda q, k, v: ff.flash_attn_forward(q, k, v, lens, causal=True, static_skip=True,
                                                   split_leaf=1024, **kw)
    expect_launches(ff, "split_leaf 1024", lambda: split4(*xb), causal_diag=1, rect_merge=3)
    hold_to_plain(torch, "split split_leaf 1024", split4, causal_plain, x32)
    split4_ms = cuda_ms(torch, lambda: split4(*xb))
    print(f"[schedules] split with split_leaf 1024 (1 diag + 3 merged rects): {split4_ms:.3f} ms "
          f"[{card}]")

    # -- one rectangle: rows [2048, 4096) x columns [0, 2048) ---------------
    rect = lambda q, k, v, **d: ff.flash_attn_forward_rect(q, k, v, lens, **region, **kw, **d)
    rect_plain = lambda q, k, v, **d: ff.flash_attn_forward_rect_plain(q, k, v, lens, **region,
                                                                       **kw, **d)
    rect_err = hold_to_plain(torch, "rect", rect, rect_plain, x32)
    rect_ms = cuda_ms(torch, lambda: rect(*xb))
    rect_pms = cuda_ms(torch, lambda: rect_plain(*xb), iters=2, warmup=1)
    lib_fwd, lib_o = library([xb[0][:, :, LEAF:], xb[1][:, :, :LEAF], xb[2][:, :, :LEAF]], LEAF,
                             LEAF, False)
    check_library(torch, "rect", lib_o, bhsd(rect_plain(*x32)[0])[0], rect_err["plain_err"])
    rect_lib = cuda_ms(torch, lib_fwd)
    rect_bound = sched_bound(LEAF * LEAF, LEAF, LEAF)
    print(f"[schedules] rect {LEAF} x {LEAF} bf16 [{card}]: kernel {rect_ms:.3f} ms, plain "
          f"{rect_pms:.3f} ms, library (aten flash on the region, not causal) {rect_lib:.3f} ms, "
          f"bound {rect_bound['bound_ms']:.4f} ms ({rect_bound['bound_by']})")
    entries["flash_fwd_rect"] = {"max_abs_err": rect_err["err"], "ms": rect_ms, "plain_ms": rect_pms,
                                 "library_ms": rect_lib, **rect_bound}
    del lib_o

    # -- the same rectangle merged into the diag leaves' (o, lse) -----------
    def merged(rect_fn):
        """The rectangle merged into the diag kernel's (o, lse), made anew."""
        def run(q, k, v, **d):
            return rect_fn(q, k, v, lens, **region, merge_prev=diag(q, k, v, **d), **kw, **d)
        return run
    merge, merge_plain = merged(ff.flash_attn_forward_rect), merged(ff.flash_attn_forward_rect_plain)
    merge_err = hold_to_plain(torch, "rect_merge", merge, merge_plain, x32)
    prev = diag(*xb)
    merge_ms = min(t["rect_merge"])
    merge_pms = cuda_ms(torch, lambda: ff.flash_attn_forward_rect_plain(
        *xb, lens, **region, merge_prev=prev, **kw), iters=2, warmup=1)
    # + the previous o and lse of the region's rows, read once.
    merge_bound = sched_bound(LEAF * LEAF, LEAF, LEAF, extra_bytes=LEAF * Hq * (D * 2 + 4))
    print(f"[schedules] rect_merge {LEAF} x {LEAF} bf16 [{card}]: kernel {merge_ms:.3f} ms, plain "
          f"{merge_pms:.3f} ms, library none (no PyTorch call merges two (o, lse) partials), bound "
          f"{merge_bound['bound_ms']:.4f} ms ({merge_bound['bound_by']})")
    entries["flash_fwd_rect_merge"] = {"max_abs_err": merge_err["err"], "ms": merge_ms,
                                       "plain_ms": merge_pms, "library_ms": None, **merge_bound}

    # -- dropout: fp32 against the plain twins fed the same mask -----------
    for what, k_fn, p_fn in (("split", split, causal_plain), ("diag", diag, diag_plain),
                             ("rect", rect, rect_plain), ("rect_merge", merge, merge_plain)):
        hold_to_plain(torch, f"{what} dropout p {DROPOUT_P} (the same mask)",
                      functools.partial(k_fn, **drop), functools.partial(p_fn, **drop), x32,
                      (torch.float32,))
    del x32, xb, prev

    # -- the strip: S 6144, and Sq 2048 against Sk 4096 ---------------------
    strip_entry = {}
    for Sq, Sk in ((STRIP_SEQ, STRIP_SEQ), (SHIFT_SQ, SHIFT_SK)):
        x32, lens = inputs(Sq, Sk)
        route = ff.forward_route(Sq, Sk, D, 2, causal=True, static_skip=True)
        if route != "strip":
            raise AssertionError(f"Sq {Sq} / Sk {Sk}: route {route}, not the strip")
        strip = lambda q, k, v, **d: ff.flash_attn_forward(q, k, v, lens, causal=True,
                                                           static_skip=True, **kw, **d)
        generic = lambda q, k, v, **d: ff.flash_attn_forward(q, k, v, lens, causal=True, **kw, **d)
        causal_plain = lambda q, k, v, **d: ff.flash_attn_forward_plain(q, k, v, lens, causal=True,
                                                                        **kw, **d)
        xb = [bf(t) for t in x32]
        expect_launches(ff, f"strip {Sq} / {Sk}", lambda: strip(*xb), causal_strip=1)
        err = hold_to_plain(torch, f"strip {Sq} / {Sk}", strip, causal_plain, x32)
        if Sq == SHIFT_SQ:
            hold_to_plain(torch, f"strip {Sq} / {Sk} dropout p {DROPOUT_P} (the same mask)",
                          functools.partial(strip, **drop), functools.partial(causal_plain, **drop),
                          x32, (torch.float32,))
        for extra in ({}, drop):
            for dt in (torch.float32, torch.bfloat16):
                x = [t.to(dt) for t in x32]
                o_s, l_s = strip(*x, **extra)
                o_g, l_g = generic(*x, **extra)
                torch.cuda.synchronize()
                if not (torch.equal(o_s, o_g) and torch.equal(l_s, l_g)):
                    raise AssertionError(f"strip {Sq} / {Sk} {dt} {extra}: not the generic kernel's "
                                         f"o / lse bit for bit")
                del x, o_s, l_s, o_g, l_g
        t = turns(torch, {"generic": lambda: generic(*xb), "strip": lambda: strip(*xb)},
                  ("generic", "strip", "strip", "generic"))
        pms = cuda_ms(torch, lambda: causal_plain(*xb), iters=2, warmup=1)
        lib_fwd, lib_o = library(xb, Sq, Sk, True)
        check_library(torch, f"strip {Sq} / {Sk}", lib_o, bhsd(causal_plain(*x32)[0])[0],
                      err["plain_err"])
        lib_ms = cuda_ms(torch, lib_fwd)
        bound = sched_bound(shifted_pairs(Sq, Sk), Sq, Sk)
        print(f"[schedules] strip Sq {Sq} / Sk {Sk} bf16 [{card}]: o and lse equal to the generic "
              f"kernel's bit for bit (fp32, bf16, with and without dropout); strip "
              f"{' / '.join(f'{v:.3f}' for v in t['strip'])} ms, generic "
              f"{' / '.join(f'{v:.3f}' for v in t['generic'])} ms, plain {pms:.3f} ms, library "
              f"(aten flash, causal) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})")
        strip_entry[(Sq, Sk)] = {"max_abs_err": err["err"], "ms": min(t["strip"]),
                                 "ms_runs": t["strip"], "generic_kernel_ms_runs": t["generic"],
                                 "plain_ms": pms, "library_ms": lib_ms, **bound}
        del x32, xb, lib_o
    entries["flash_fwd_causal_strip"] = dict(strip_entry[(STRIP_SEQ, STRIP_SEQ)],
                                             shifted_2048_4096=strip_entry[(SHIFT_SQ, SHIFT_SK)])
    return entries


def long_flash_attn_func(torch):
    """flash_attn_func forward + backward at B 1 x S 4096 (bf16, causal, no
    mask), launch counts reset just before: the split forward, then the
    ported dq and dk/dv kernels on its o and lse; output and gradients meet
    the FA rules against the fp32 plain twins."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    S, D = LONG_SEQ, 128
    x32 = [torch.randn((1, S, h, D), generator=gen, device=dev) * 0.5 for h in (32, 8, 8)]
    do32 = torch.randn((1, S, 32, D), generator=gen, device=dev)
    leaves = [x.to(torch.bfloat16).requires_grad_() for x in x32]
    do = do32.to(torch.bfloat16)
    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves, causal=True, return_lse=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {**sched_launches(flash_fwd), **flash_bwd.LAUNCHES}
    print(f"[schedules] flash_attn_func(causal) + backward, B 1 x S {S}, Hq 32, Hkv 8, D {D}, "
          f"bf16: launches {launches}")
    want = {"flash_fwd": 0, "causal_strip": 0, "causal_diag": 1, "rect": 0, "rect_merge": 1,
            "flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"flash_attn_func at S {S}: launches {launches} != {want}")
    bhsd = lambda x: x.transpose(1, 2)
    lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    with torch.no_grad():
        o32, lse32 = flash_fwd.flash_attn_forward_plain(*(bhsd(x) for x in x32), lens, **kw)
        q, k, v = (bhsd(x.detach()) for x in leaves)
        o_pl, _ = flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw)
        out_err, pl_err = max_abs(torch, bhsd(out), o32), max_abs(torch, o_pl, o32)
        if not out_err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
            raise AssertionError(f"S {S} forward: err {out_err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
        refs = flash_bwd.flash_attn_backward_plain(*(bhsd(x) for x in x32), bhsd(do32), o32, lse32,
                                                   lens, **kw)
        del o32, lse32, o_pl
        plains = flash_bwd.flash_attn_backward_plain(q, k, v, bhsd(do), bhsd(out.detach()),
                                                     lse.detach(), lens, **kw)
    errs = {n: check_grad(torch, n, bhsd(x.grad), r, pl, f"S {S}")[0]
            for n, x, r, pl in zip(("dq", "dk", "dv"), leaves, refs, plains)}
    print(f"[schedules] S {S} through the split: out err {out_err:.3e} (<= 2 x plain {pl_err:.3e} + "
          f"5e-5); grad errs vs fp32 " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + " (FA gradient contract)")
    del refs, plains
    # The attention of one layer of the 1 x 4096 trainer (PERF.md's step
    # breakdown): the split's diag and merged rectangle by CUDA events, one
    # call each (both are flash_fwd.cu's kernel, one name in a profile), and
    # the backward's dq and dk/dv kernels by the profiler.
    scale = dict(softmax_scale=D ** -0.5)
    prev = flash_fwd.flash_attn_forward_causal_diag(q, k, v, lens, T=LEAF, **scale)
    per = {"diag": cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_causal_diag(
               q, k, v, lens, T=LEAF, **scale)),
           "rect_merge": cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_rect(
               q, k, v, lens, row0=LEAF, col0=0, nrows=LEAF, ncols=LEAF, merge_prev=prev, **scale))}
    per.update(kernel_ms(torch, lambda: flash_attn_func(*leaves, causal=True).backward(do),
                         ("dq_mma_kernel", "dkdv_mma_kernel")))
    fwd_ms = per["diag"] + per["rect_merge"]
    pair_ms = per["dq_mma_kernel"] + per["dkdv_mma_kernel"]
    print(f"[schedules] flash_attn_func fwd + bwd B 1 x S {S} bf16 kernels (per launch): "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in per.items())
          + f"; attention of one layer {sum(per.values()):.3f} ms; of a remat step of the 32-layer "
          f"trainer 32 x (2 x {fwd_ms:.3f} (split forward) + {pair_ms:.3f} (dq + dk/dv)) = "
          f"{32 * (2 * fwd_ms + pair_ms) / 1e3:.3f} s")
    return launches


def strip_and_rect_paths(torch):
    """The strip's default routes through flash_attn_func (forward, S 6144
    and a 2048-query chunk against 4096 keys) and the rectangle through its
    own entry point (the split always merges, as in JAX), each with the
    launch counts reset just before. Returns their launches."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    D, runs = 128, {}
    for Sq, Sk in ((STRIP_SEQ, STRIP_SEQ), (SHIFT_SQ, SHIFT_SK)):
        q, k, v = (torch.randn((1, s, h, D), generator=gen, device=dev).to(torch.bfloat16)
                   for s, h in ((Sq, 32), (Sk, 8), (Sk, 8)))
        with torch.no_grad():
            out, got = expect_launches(flash_fwd, f"flash_attn_func {Sq} / {Sk}",
                                       lambda: flash_attn_func(q, k, v, causal=True),
                                       causal_strip=1)
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_attn_func {Sq} / {Sk}: non-finite output")
        runs[f"flash_attn_func {Sq} / {Sk}"] = got
        del q, k, v, out
    q, k, v = (torch.randn((1, h, LONG_SEQ, D), generator=gen, device=dev).to(torch.bfloat16)
               for h in (32, 8, 8))
    lens = torch.tensor([[LONG_SEQ, LONG_SEQ]], dtype=torch.int32, device=dev)
    (o, lse), got = expect_launches(flash_fwd, "flash_attn_forward_rect", lambda: (
        flash_fwd.flash_attn_forward_rect(q, k, v, lens, row0=LEAF, col0=0, nrows=LEAF, ncols=LEAF,
                                          softmax_scale=D ** -0.5)), rect=1)
    if o.shape != (1, 32, LEAF, D) or not torch.isfinite(lse).all():
        raise AssertionError("flash_attn_forward_rect: bad region output")
    runs["flash_attn_forward_rect"] = got
    print(f"[schedules] launches by run: {runs}")
    return runs


def long_train(torch, card: str):
    """The trainer at batch 1 x seq 4096, full depth: attention over 4095
    tokens takes the split (diag + one merged rectangle per layer call)."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    def reset():
        flash_fwd.reset_launches()
        flash_bwd.reset_launches()

    args, res = run_trainer(torch, card, LONG_TRAIN_ARGV, reset, "schedules train")
    launches = {**sched_launches(flash_fwd), **flash_bwd.LAUNCHES}
    L, steps = res["config"].n_layers, args.steps
    print(f"[schedules train] launches: {launches}")
    want = {"flash_fwd": 0, "causal_strip": 0, "causal_diag": 2 * L * steps, "rect": 0,
            "rect_merge": 2 * L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"1 x {LONG_SEQ} training launches {launches} != {want} (layers x "
                             f"steps, x2 for remat)")
    return launches


def phase_schedules(torch, card: str):
    """Phase 11: the causal forward schedules. Returns (launches by run,
    kernel entries)."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    t0 = time.perf_counter()
    if any(flash_fwd.SCHEDULE_LAUNCHES.values()):
        raise AssertionError(f"phases 1-10 launched a schedule kernel: {flash_fwd.SCHEDULE_LAUNCHES}")
    print("[schedules] phases 1-10 launched no schedule kernel: "
          f"{dict(flash_fwd.SCHEDULE_LAUNCHES)}")
    entries = schedule_kernels(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"flash_attn_func S 4096": long_flash_attn_func(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(strip_and_rect_paths(torch))
    gc.collect()
    torch.cuda.empty_cache()
    runs["train"] = long_train(torch, card)
    print(f"[schedules] phase 11 took {time.perf_counter() - t0:.1f} s")
    return runs, entries


# Phase 12: the causal backward schedules at Qwen1.5-7B attention widths (32 /
# 32 heads, D 128, bf16, causal, no mask). The trainer feeds attention seq - 1
# tokens: 2 x 2047 takes the tri-square backward (B13), 1 x 8191 (padded 8192)
# the work list (B14) with four strips of 2048.
QWEN_H, QWEN_D = 32, 128
TRI_B, TRI_S = 2, 2047
WL_S = 8191
SPLIT_S, SPLIT_LEAF = 4096, 2048  # the split forced: one diag launch over two leaves, one rect
QWEN_STEPS = 3
# Batch x seq of the two Qwen training runs; if 1 x 8192 runs out of memory,
# 1 x 6144 (6143 tokens pad to 6144: the same work-list route, three strips).
QWEN_SHAPES = ((2, 2048), (1, 8192))
QWEN_FALLBACK_SEQ = 6144
BWD_NAMES = ("dq", "dk", "dv")


def qwen_train_argv(batch: int, seq: int):
    return ["--config", "qwen1.5-7b", "--steps", str(QWEN_STEPS), "--batch", str(batch), "--seq",
            str(seq), "--remat", "--repeat-batch", "--lr", "3e-4", "--grad-clip", "1.0"]


def fused_bound(pairs: int, q_rows: int, kv_rows: int, Hq: int = QWEN_H, Hkv: int = QWEN_H,
                D: int = QWEN_D, elt: int = 2) -> dict:
    """Bound of a fused backward over `pairs` kept (query, key) pairs per q
    head: 10 D operations per pair and head (s, dp, dv, dk, dq); q, o, do,
    dq of `q_rows` rows and k, v, dk, dv of `kv_rows` rows read or written
    once, with the fp32 lse and delta of the q rows."""
    nbytes = 4 * q_rows * Hq * D * elt + 4 * kv_rows * Hkv * D * elt + 2 * q_rows * Hq * 4
    return roofline(10 * D * pairs * Hq, nbytes)


def bwd_launches(flash_fwd, flash_bwd):
    """Every launch count; the backward schedules' under "bwd_<name>" (the
    forward's have a causal_diag and a rect too)."""
    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES, **flash_bwd.LAUNCHES,
            **{f"bwd_{n}": c for n, c in flash_bwd.SCHEDULE_LAUNCHES.items()}}


def hold_bwd(torch, what, kernel, plain, inputs):
    """kernel(*inputs(dtype), **drop) and plain(...) -> (dq, dk, dv): fp32
    within FP32_GRAD_RTOL x (1 + max|g|) of the plain twin, bf16 within the
    FA gradient contract of the fp32 plain (the truth, dV waiver), fp32 with
    dropout p DROPOUT_P against the plain twin fed the same mask, and two
    bf16 runs equal bit for bit. Returns the bf16 errors by gradient."""
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    x32 = inputs(torch.float32)
    truth = plain(*x32)
    errs = {}
    for extra in ({}, drop):
        got = kernel(*x32, **extra)
        ref = truth if not extra else plain(*x32, **extra)
        torch.cuda.synchronize()
        errs32 = [check_fp32_grad(torch, n, g, r, f"{what} fp32{' dropout' if extra else ''}")
                  for n, g, r in zip(BWD_NAMES, got, ref)]
        del got, ref
        print(f"[causal bwd] {what} fp32{f' dropout p {DROPOUT_P} (the same mask)' if extra else ''}"
              f": max abs errs vs the plain twin "
              + ", ".join(f"{n} {e:.3e}" for n, e in zip(BWD_NAMES, errs32))
              + f" (<= {FP32_GRAD_RTOL} x (1 + max|grad|))")
    xb = inputs(torch.bfloat16)
    got, again = kernel(*xb), kernel(*xb)
    pl = plain(*xb)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two bf16 runs differ")
    for n, g, r, p in zip(BWD_NAMES, got, truth, pl):
        errs[n], errs[n + " plain"] = check_grad(torch, n, g, r, p, f"{what} bf16")
    print(f"[causal bwd] {what} bf16: errs vs fp32 truth " + ", ".join(
        f"{n} {errs[n]:.3e} (plain {errs[n + ' plain']:.3e})" for n in BWD_NAMES)
        + " (FA gradient contract); two runs equal bit for bit")
    return errs, truth


def profiler_split(torch, fn, names):
    """Device ms per launch of each named kernel from torch.profiler, or
    None where it recorded no launch: late in this long process it can drop
    every launch of a call (0 of 3 of the tri-square's, once), so phase 12's
    kernel times are CUDA events over whole calls and this split is extra."""
    try:
        return kernel_ms(torch, fn, names, iters=3)
    except AssertionError as e:
        print(f"[causal bwd] no profiler split: {e}")
        return None


def forward_ms(torch, x, card):
    """The forward the trainer runs at these inputs' shape (the generic
    kernel, `flash_attn_forward`'s route for 2047 and 8191 tokens): its
    CUDA-event ms (with the backward's time, one layer's attention per
    step), its bound, aten flash's causal forward on the same inputs and the
    share of the bound. Returns those numbers."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    q, k, v, _, _, _, lens = x
    B, Hq, S, _ = q.shape
    if flash_fwd.forward_route(S, S, QWEN_D, 2, causal=True, static_skip=True) not in (
            "tri_square", "generic"):
        raise AssertionError(f"S {S}: the trainer's forward is not the generic kernel")
    run = lambda: flash_fwd.flash_attn_forward(q, k, v, lens, causal=True,  # noqa: E731
                                               softmax_scale=QWEN_D ** -0.5)
    t = turns(torch, {"kernel": run}, ("kernel",) * 3, iters=3)["kernel"]
    seq = [S] * B
    lib_fwd, _, _ = library_attention(torch, *(tight(torch, t_.transpose(1, 2), seq)
                                               for t_ in (q, k, v)), seq, seq, True,
                                      QWEN_D ** -0.5)
    lib_ms = cuda_ms(torch, lib_fwd, iters=3)
    bound = attn_bound("fwd", causal_pairs(seq), sum(seq), Hq, k.shape[1], QWEN_D, 2)
    share = bound["bound_ms"] / min(t)
    print(f"[causal bwd] generic forward kernel B {B} x S {S} bf16 [{card}]: "
          f"{' / '.join(f'{v:.3f}' for v in t)} ms (the FMA design: "
          f"{FWD_FMA_DESIGN_MS.get((B, S), 'not measured')} ms), library (aten flash, causal) "
          f"{lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
          f"{100 * share:.1f} % of the bound")
    return {"ms": min(t), "ms_runs": t, "library_ms": lib_ms, **bound, "bound_share": share}


def bwd_kernel_inputs(torch, gen, B, S, Hq=QWEN_H, Hkv=QWEN_H):
    """inputs(dtype) -> (q, k, v, do, o, lse, lens) BHSD at the given
    widths: fp32 randoms cast to dtype, o and lse from the generic forward
    kernel in that dtype."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    dev = torch.device("cuda")
    bhsd = lambda x: x.transpose(1, 2)
    x32 = [bhsd(torch.randn((B, S, h, QWEN_D), generator=gen, device=dev) * 0.5)
           for h in (Hq, Hkv, Hkv)]
    do32 = bhsd(torch.randn((B, S, Hq, QWEN_D), generator=gen, device=dev))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=dev)
    cache = {}

    def inputs(dt):
        if dt not in cache:
            q, k, v, do = (x.to(dt) for x in (*x32, do32))
            o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, causal=True,
                                                  softmax_scale=QWEN_D ** -0.5)
            cache[dt] = (q, k, v, do, o, lse, lens)
        return cache[dt]
    return inputs


def library_bwd(torch, what, x, seq_q, seq_k, causal, truth, errs, rows=None, cols=None):
    """aten's flash backward (`aten._flash_attention_backward`, after its
    own forward) on the same bf16 tensors (tight-packed rows), checked to
    compute the fp32 `truth` (its error near the bf16 plain twin's):
    CUDA-event ms of one call."""
    q, k, v, do = x[:4]
    rows, cols = rows or slice(None), cols or slice(None)
    bshd = lambda t, sl: t[:, :, sl].transpose(1, 2)
    pack = lambda t, sl, lens: tight(torch, bshd(t, sl), lens)
    B = q.shape[0]
    lq, lk = [seq_q] * B, [seq_k] * B
    _, _, lib = library_attention(torch, pack(q, rows, lq), pack(k, cols, lk), pack(v, cols, lk),
                                  lq, lk, causal, QWEN_D ** -0.5)
    run = lib(pack(do, rows, lq))
    for n, g, r in zip(BWD_NAMES, run(), truth):
        check_library(torch, f"{what} {n}", g, tight(torch, r.transpose(1, 2), lq if n == "dq"
                                                     else lk), errs[n + " plain"])
    return cuda_ms(torch, run, iters=5)


# The bf16 times of these kernels' earlier design (fp32 FMA tiles, one block
# per batch row and kv head or per strip) at these shapes, measured by this
# phase on an NVIDIA H100 80GB HBM3 at 700.00 W (CUDA events, four runs; dq
# and dk/dv: phase 5's profiler times at B 2 x S 2047, 32 / 8 heads),
# printed beside this run's in the log only: the kernels line holds numbers
# this run measured. Each redesigned kernel must beat its FMA time (the dq
# and dk/dv pair by 3x).
FMA_DESIGN_MS = {"tri_square": "20.331-20.379", "causal_diag": "19.939-20.105",
                 "worklist": "138.520-139.322", "rect": "11.696-11.819", "dq": "5.399",
                 "dkdv": "8.425"}
# The split forward's FMA design (B9 diag + B11 / B1 merge as fp32 FMA tiles)
# at B 1 x S 4096, 32 / 8 heads, D 128, bf16, measured by phase 11 on an
# NVIDIA H100 80GB HBM3 at 700.00 W (CUDA events over whole calls; the two
# kernels by the profiler inside the split). Every split run on tensor cores
# must beat the top of its range SPLIT_SPEEDUP times.
FMA_DESIGN_MS.update({"split_fwd": "6.576-6.607", "diag_fwd": "3.388-3.445",
                      "rect_merge_fwd": "3.152-3.185"})
SPLIT_SPEEDUP = 3
# The packed backward's FMA design (fp32 FMA tiles for every input type) on
# phase 8's packed batch (T 14592) and phase 9's block-sparse batch, bf16,
# 32 / 8 heads, D 128, measured by those phases on an NVIDIA H100 80GB HBM3
# at 700.00 W (profiler, two to four runs). Every tensor-core run must beat
# the top of its range VARLEN_SPEEDUP times.
FMA_DESIGN_MS.update({"varlen_dq": "17.334-17.387", "varlen_dkdv": "41.094-41.138",
                      "blocksparse_dq": "5.176-5.204", "blocksparse_dkdv": "15.3-19.7"})
# The packed forward's FMA design (B7 as fp32 FMA tiles for every input
# type), measured the same way by the earlier builds' runs of phases 8 and 9.
FMA_DESIGN_MS.update({"varlen_fwd": "10.898-11.412", "blocksparse_fwd": "3.315-3.353"})
# The same on phase 10's packed batch with dropout p 0.1 (the earlier builds' runs).
FMA_DESIGN_MS.update({"varlen_dropout_fwd": "11.174-11.336", "varlen_dropout_dq": "17.29-17.53",
                      "varlen_dropout_dkdv": "26.35-27.59"})
VARLEN_SPEEDUP = 3
# The dbias kernel's FMA design (fp32 FMA tiles for every input type, 64 x 32
# bias tiles), bf16, measured by phase 6 (B 2 x S 2047) and by phase 10's
# bias path with dropout (B 2 x S 2048) on an NVIDIA H100 80GB HBM3 at
# 700.00 W (profiler). The tensor-core kernel must beat the top of each
# DBIAS_SPEEDUP times.
FMA_DESIGN_MS.update({"dbias": "5.268", "dbias_dropout": "5.404-5.475"})
DBIAS_SPEEDUP = 3

# The 16-bit tensor-core kernels: the fused backward (csrc/bwd_mma.cuh's
# tiles), the forward (csrc/flash_fwd.cu), the dq + dk/dv pair and dbias
# (csrc/flash_bwd.cu) and the packed forward and backward (csrc/varlen.cu,
# the forward on csrc/fwd_mma.cuh's tiles like flash_fwd.cu's); the template
# flag after DROP of the forward's and the pair's puts bias and softcap in
# their own instantiations, and the forward's last one (MERGE) the split's
# merged rectangle. A mangled name gives each name its length just before
# it, so the pattern asks for a digit there: the pair's names are not read
# inside a longer one.
MMA_KERNELS = ("bwd_tri_mma_kernel", "bwd_wl_mma_kernel", "flash_fwd_mma_kernel", "dq_mma_kernel",
               "dkdv_mma_kernel", "dbias_mma_kernel", "varlen_mma_fwd_kernel",
               "varlen_mma_dq_kernel", "varlen_mma_dkdv_kernel")
# Kernels none of whose instantiations may spill.
NO_SPILL_KERNELS = ("varlen_mma_fwd_kernel",)
MMA_EXTRA = ("flash_fwd_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel")
_MMA_NAME = re.compile(r"\d(" + "|".join(MMA_KERNELS) + r")I(13__nv_bfloat16|6__half)Li(\d+)ELb([01])E"
                       r"(?:Lb([01])E)?(?:Lb([01])E)?")
# The forward's (bias / softcap, merge) instantiations: a merge has neither.
FWD_FLAGS = ((False, False), (True, False), (False, True))
# The forward's times at the Qwen shapes in its earlier design (fp32 FMA
# tiles for every input type), measured by this phase on an NVIDIA H100 80GB
# HBM3 at 700.00 W (CUDA events, four runs), for the log line only.
FWD_FMA_DESIGN_MS = {(2, 2047): "3.462-3.509", (1, 8191): "25.271-25.795"}


def mma_instance(mangled: str):
    """(kernel, dtype, D, dropout, bias / softcap, merge) of a 16-bit
    kernel's mangled name (False for a flag the kernel does not have), else
    None."""
    m = _MMA_NAME.search(mangled)
    return (m[1], "bf16" if "bfloat" in m[2] else "fp16", int(m[3]), m[4] == "1",
            m[5] == "1", m[6] == "1") if m else None


def ptxas_table(report: str) -> dict:
    """{instance: (registers, spill store bytes, spill load bytes)} of the
    16-bit tensor-core kernels, from nvcc -Xptxas -v's report."""
    regs, spills, cur, prop = {}, {}, None, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = m[1]
        elif m := re.search(r"Function properties for (\S+)", line):
            prop = m[1]
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and prop:
            spills[prop] = (int(m[1]), int(m[2]))
        elif (m := re.search(r"Used (\d+) registers", line)) and cur:
            regs[cur] = int(m[1])
    return {mma_instance(n): (r, *spills.get(n, (0, 0))) for n, r in regs.items()
            if mma_instance(n)}


def hmma_counts(lib_path) -> dict:
    """{instance: HMMA instructions} of the 16-bit tensor-core kernels in
    the SASS of the built library (cuobjdump -sass)."""
    from fa2_triton_tpu_torch.ops import _build

    tool = _build.find_cuobjdump()
    if tool is None:
        raise AssertionError("no cuobjdump beside nvcc or in Triton's package")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            cur = mma_instance(m[1])
            if cur:
                counts[cur] = 0
        elif cur and "HMMA" in line:
            counts[cur] += 1
    return counts


def mma_build_report() -> dict:
    """Registers, spills and tensor-core instructions of every 16-bit
    instantiation of the two fused backward kernels, the forward, the dq
    + dk/dv pair and dbias (bf16 / fp16 x D 64 / 128 / 256 x dropout, and for the
    forward and the pair with and without bias / softcap, for the forward
    also the split's merge; the packed forward, dq and dk/dv); fails where
    one has no HMMA, or a bf16 D 128 one of the trainers' (the Qwen and
    Mistral shapes': no bias, no softcap; the merge included) or any one of
    NO_SPILL_KERNELS spills.
    Returns {kernel: {instance: numbers}}."""
    from fa2_triton_tpu_torch.ops import _build

    table = ptxas_table(_build.ptxas_report or "")
    hmma = hmma_counts(_build.build())
    out = {k: {} for k in MMA_KERNELS}
    for kernel in MMA_KERNELS:
        flags = (FWD_FLAGS if kernel == "flash_fwd_mma_kernel" else
                 ((False, False), (True, False)) if kernel in MMA_EXTRA else ((False, False),))
        for dt, D, drop, (extra, merge) in itertools.product(("bf16", "fp16"), (64, 128, 256),
                                                             (False, True), flags):
            inst = (kernel, dt, D, drop, extra, merge)
            if inst not in table or inst not in hmma:
                raise AssertionError(f"{inst}: not in the ptxas report / the SASS")
            regs, st, ld = table[inst]
            n = hmma[inst]
            what = (f"{dt} D {D}{' dropout' if drop else ''}{' bias / softcap' if extra else ''}"
                    f"{' merge' if merge else ''}")
            print(f"[tensor cores] {kernel} {what}: {regs} registers, spill stores {st} B / "
                  f"loads {ld} B, {n} HMMA in the SASS")
            if n == 0:
                raise AssertionError(f"{inst}: no tensor-core instruction")
            if (st or ld) and (kernel in NO_SPILL_KERNELS or (dt == "bf16" and D == 128
                                                               and not extra)):
                raise AssertionError(f"{inst}: spills {st} / {ld} bytes")
            out[kernel][f"{dt} D{D}{' drop' if drop else ''}{' extra' if extra else ''}"
                        f"{' merge' if merge else ''}"] = {
                "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld, "hmma": n}
    return out


def decode_build_report() -> dict:
    """Registers and spills of every `decode_kernel` instantiation (T x
    cache x layout x D x G: 216) from nvcc -Xptxas -v's report, and the HMMA
    count of the 16-bit ones in the SASS; fails on any spill, on a count
    other than 216 or on a 16-bit instantiation without tensor-core
    instructions. Returns the summary."""
    from fa2_triton_tpu_torch.ops import _build

    regs, spills, cur, prop = {}, {}, None, None
    for line in (_build.ptxas_report or "").splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = m[1] if "decode_kernel" in m[1] else None
        elif m := re.search(r"Function properties for (\S+)", line):
            prop = m[1] if "decode_kernel" in m[1] else None
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and prop:
            spills[prop] = int(m[1]) + int(m[2])
        elif (m := re.search(r"Used (\d+) registers", line)) and cur:
            regs[cur] = int(m[1])
    sass = subprocess.run([_build.find_cuobjdump(), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m[1] if "decode_kernel" in m[1] else None
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in line:
            hmma[fn] += 1
    sixteen = [n for n in regs if "decode_kernelIf" not in n]   # q bf16 / fp16
    spilled = {n: b for n, b in spills.items() if b}
    no_mma = [n for n in sixteen if not hmma.get(n)]
    # bf16 q over a bf16 contiguous cache, D 128, G 4 (the served shape).
    bf16 = next((n for n in regs
                 if re.search(r"decode_kernelI13__nv_bfloat16S\d*_Lb0ELi128ELi4E", n)), None)
    summary = {"instantiations": len(regs), "registers_min": min(regs.values(), default=0),
               "registers_max": max(regs.values(), default=0), "spilled": len(spilled),
               "sixteen_bit": len(sixteen), "sixteen_bit_without_hmma": len(no_mma),
               "bf16_D128_G4_registers": regs.get(bf16), "bf16_D128_G4_hmma": hmma.get(bf16)}
    print(f"[decode build] {summary['instantiations']} decode_kernel instantiations: "
          f"{summary['registers_min']}-{summary['registers_max']} registers, "
          f"{len(spilled)} spill; {len(sixteen)} 16-bit, each with HMMA in the SASS "
          f"({len(no_mma)} without); bf16 contiguous D 128 G 4: {regs.get(bf16)} registers, "
          f"{hmma.get(bf16)} HMMA")
    if len(regs) != 216 or spilled or no_mma or not sixteen:
        raise AssertionError(f"decode build: {len(regs)} instantiations, spills {spilled}, "
                             f"16-bit without HMMA {no_mma[:4]}")
    return summary


def fused_over_pair(fused_runs, pair_runs) -> float:
    """The fused schedule's best time over the dq + dk/dv pair's best."""
    return min(fused_runs) / min(pair_runs)


def beats_fma_design(name, runs, by=1):
    """Fail unless every run is `by` times faster than the kernel's FMA
    design (the top of its FMA_DESIGN_MS range): what the fused tensor-core
    kernels must hold now that the pair runs on tensor cores as well and may
    rightly beat them, and the split forward (by SPLIT_SPEEDUP)."""
    fma = float(FMA_DESIGN_MS[name].split("-")[-1])
    if not max(runs) * by < fma:
        raise AssertionError(f"{name} {runs} ms is not {by}x faster than its FMA design's {fma} ms")


def print_partition(what, loads, heads_x_batch, sms):
    """Blocks launched, blocks per (leaf, kv head, batch row) and the
    largest / mean work of a partition."""
    blocks = len(loads) * heads_x_batch
    ratio = max(loads) * len(loads) / sum(loads)
    print(f"[causal bwd] {what}: {blocks} blocks ({len(loads)} per kv head and batch row; "
          f"{sms} SMs), largest / mean work {ratio:.3f} (work per block {list(loads)})")
    if blocks < sms or ratio > 1.25:
        raise AssertionError(f"{what}: {blocks} blocks, largest / mean {ratio:.3f}")
    return {"blocks": blocks, "blocks_per_head": len(loads), "largest_over_mean": ratio}


def causal_bwd_kernels(torch, card):
    """Each backward schedule kernel held against its plain twin, with
    launches through `flash_attn_backward`'s routing, times (kernel, plain,
    library, the generic dq + dk/dv pair at the same shape) and bounds.
    Returns (launches by run, kernel entries)."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    gen = torch.Generator(device="cuda").manual_seed(12)
    scale = QWEN_D ** -0.5
    kw = dict(softmax_scale=scale)
    entries, runs = {}, {}

    def routed(x, **extra):
        return fb.flash_attn_backward(*x, causal=True, static_skip=True, **kw, **extra)

    def generic(x):
        return fb.flash_attn_backward(*x, causal=True, **kw)

    def launches_of(what, run, **want):
        ff.reset_launches()
        fb.reset_launches()
        run()
        torch.cuda.synchronize()
        got = bwd_launches(ff, fb)
        want = {n: want.get(n, 0) for n in got}
        print(f"[causal bwd] {what}: launches {got}")
        if got != want:
            raise AssertionError(f"{what}: launches {got} != {want}")
        return got

    # -- B13 tri-square at the 2 x 2048 trainer's shape ------------------------
    inputs = bwd_kernel_inputs(torch, gen, TRI_B, TRI_S)
    if fb.backward_route(TRI_S, TRI_S, QWEN_D, 2, causal=True, static_skip=True) != "tri_square":
        raise AssertionError("B 2 x S 2047 MHA does not route to the tri-square")
    tri = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_tri_square(
        q, k, v, do, o, lse, lens, **kw, **d)
    tri_plain = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_plain(
        q, k, v, do, o, lse, lens, causal=True, **kw, **d)
    errs, truth = hold_bwd(torch, f"tri_square B {TRI_B} x S {TRI_S}", tri, tri_plain, inputs)
    xb = inputs(torch.bfloat16)
    runs["tri_square"] = launches_of(f"flash_attn_backward(causal, static_skip) B {TRI_B} x S "
                                     f"{TRI_S}", lambda: routed(xb), bwd_tri_square=1)
    sms = fb.sm_count(xb[0].device)
    P, _, _, loads = fb.tri_partition(TRI_S, TRI_S, 0, 0, 1, TRI_B, QWEN_H, QWEN_D, sms)
    part = print_partition(f"tri_square B {TRI_B} x S {TRI_S} partition (P {P})", loads,
                           TRI_B * QWEN_H, sms)
    t = turns(torch, {"generic": lambda: generic(xb), "tri": lambda: tri(*xb)},
              ("generic", "tri", "tri", "generic"), iters=3)
    per = profiler_split(torch, lambda: tri(*xb), ("fused_delta", "bwd_tri_mma_kernel",
                                                   "tri_dq_reduce"))
    fwd = forward_ms(torch, xb, card)
    pms = cuda_ms(torch, lambda: tri_plain(*xb), iters=2, warmup=1)
    lib_ms = library_bwd(torch, "tri_square", xb, TRI_S, TRI_S, True, truth, errs)
    bound = fused_bound(TRI_B * causal_pairs([TRI_S]), TRI_B * TRI_S, TRI_B * TRI_S)
    print(f"[causal bwd] tri_square B {TRI_B} x S {TRI_S} bf16 [{card}]: call (delta prologue, "
          f"kernel, dq reduction; CUDA events) {' / '.join(f'{v:.3f}' for v in t['tri'])} ms"
          + (f" (profiler: delta {per['fused_delta']:.3f}, kernel {per['bwd_tri_mma_kernel']:.3f}, "
             f"dq reduction {per['tri_dq_reduce']:.3f} ms)" if per else "")
          + f" (the FMA design: {FMA_DESIGN_MS['tri_square']} ms), generic dq + dk/dv "
          f"pair {' / '.join(f'{v:.3f}' for v in t['generic'])} ms (fused / pair "
          f"{fused_over_pair(t['tri'], t['generic']):.3f}), plain {pms:.3f} ms, library "
          f"(aten flash backward, causal) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})")
    beats_fma_design("tri_square", t["tri"])
    entries["flash_bwd_tri_square"] = {
        "max_abs_err": max(errs[n] for n in BWD_NAMES), "ms": min(t["tri"]),
        "ms_runs": t["tri"], "profiler_ms": per, "generic_pair_ms_runs": t["generic"],
        "fused_over_pair": fused_over_pair(t["tri"], t["generic"]),
        "plain_ms": pms, "library_ms": lib_ms, "forward_kernel": fwd, "partition": part,
        **bound}
    del inputs, xb, truth
    gc.collect()
    torch.cuda.empty_cache()

    # -- B14 work list at the 1 x 8192 trainer's shape: four strips ------------
    inputs = bwd_kernel_inputs(torch, gen, 1, WL_S)
    if fb.backward_route(WL_S, WL_S, QWEN_D, 2, causal=True, static_skip=True) != "worklist":
        raise AssertionError("B 1 x S 8191 MHA does not route to the work list")
    wl_kw = dict(sub=512, block_kv=2048)
    wl = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_fused_wl(
        q, k, v, do, o, lse, lens, **wl_kw, **kw, **d)
    key = fb._wl_geometry(WL_S, WL_S, 1, 0, 512, 2048)
    schedule = (key[0], 512, key[1], key[2], 1, 0, (-1, -1), True, key[3], key[4])
    table, starts = fb._worklist(*schedule)
    print(f"[causal bwd] work list at S {WL_S}: {len(table)} steps per head in {len(starts) - 1} "
          f"strips of {[int(b - a) for a, b in zip(starts[:-1], starts[1:])]} steps, dq_whole "
          f"{key[4]}")
    sms = fb.sm_count(torch.device("cuda"))
    chunk_starts, _, _, loads = fb.wl_partition(schedule, WL_S, WL_S, 1, QWEN_H, QWEN_D, sms)
    part = print_partition(f"worklist B 1 x S {WL_S} chunks (at most "
                           f"{int(max(np.diff(chunk_starts)))} steps)", loads, QWEN_H, sms)
    wl_plain = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_fused_wl_plain(
        q, k, v, do, o, lse, lens, schedule=schedule, **kw, **d)
    errs, truth = hold_bwd(torch, f"worklist B 1 x S {WL_S}", wl, wl_plain, inputs)
    xb = inputs(torch.bfloat16)
    runs["worklist"] = launches_of(f"flash_attn_backward(causal, static_skip) B 1 x S {WL_S}",
                                   lambda: routed(xb), bwd_worklist=1)
    t = turns(torch, {"generic": lambda: generic(xb), "wl": lambda: wl(*xb)},
              ("generic", "wl", "wl", "generic"), iters=2)
    fwd = forward_ms(torch, xb, card)
    per = profiler_split(torch, lambda: wl(*xb), ("bwd_wl_mma_kernel", "wl_mma_reduce"))
    pms = cuda_ms(torch, lambda: wl_plain(*xb), iters=1, warmup=1)
    lib_ms = library_bwd(torch, "worklist", xb, WL_S, WL_S, True, truth, errs)
    bound = fused_bound(causal_pairs([WL_S]), WL_S, WL_S)
    print(f"[causal bwd] worklist B 1 x S {WL_S} bf16 [{card}]: call (the host's k prescale and "
          f"delta, the kernel, the dk / dv / dq reduction; CUDA events) "
          f"{' / '.join(f'{v:.3f}' for v in t['wl'])} ms"
          + (f" (profiler: kernel {per['bwd_wl_mma_kernel']:.3f}, reduction "
             f"{per['wl_mma_reduce']:.3f} ms)" if per else "")
          + f" (the FMA design: {FMA_DESIGN_MS['worklist']} ms), generic dq + dk/dv pair "
          f"{' / '.join(f'{v:.3f}' for v in t['generic'])} ms (fused / pair "
          f"{fused_over_pair(t['wl'], t['generic']):.3f}), plain (the table walk) {pms:.3f} ms, "
          f"library (aten flash backward, causal) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} "
          f"ms ({bound['bound_by']})")
    beats_fma_design("worklist", t["wl"])
    entries["flash_bwd_worklist"] = {
        "max_abs_err": max(errs[n] for n in BWD_NAMES), "ms": min(t["wl"]), "ms_runs": t["wl"],
        "profiler_ms": per, "generic_pair_ms_runs": t["generic"],
        "fused_over_pair": fused_over_pair(t["wl"], t["generic"]), "plain_ms": pms,
        "library_ms": lib_ms, "forward_kernel": fwd, "partition": part, **bound}
    del inputs, xb, truth
    gc.collect()
    torch.cuda.empty_cache()

    # -- B13 split forced with split_leaf 2048 at B 1 x S 4096 -----------------
    inputs = bwd_kernel_inputs(torch, gen, 1, SPLIT_S)
    split = lambda q, k, v, do, o, lse, lens, **d: routed((q, k, v, do, o, lse, lens),
                                                          causal_split=True, split_leaf=SPLIT_LEAF,
                                                          **d)
    xb = inputs(torch.bfloat16)
    runs["split"] = launches_of(f"flash_attn_backward(causal_split, split_leaf {SPLIT_LEAF}) B 1 x "
                                f"S {SPLIT_S}", lambda: split(*xb), bwd_causal_diag=1,
                                bwd_rect=1)
    hold_bwd(torch, f"split S {SPLIT_S}", split, tri_plain, inputs)
    split_ms = cuda_ms(torch, lambda: split(*xb), iters=3)

    def prescaled(x):
        q, k, v, do, o, lse, lens = x
        return q, fb._prescale_k(k, scale), v, do, lse, fb.compute_delta(o, do, lse), lens

    region = dict(row0=SPLIT_LEAF, col0=0, nrows=SPLIT_LEAF, ncols=SPLIT_LEAF)
    diag = lambda *x, **d: fb.flash_attn_backward_causal_diag(*prescaled(x), T=SPLIT_LEAF,
                                                              **kw, **d)
    diag_plain = lambda *x, **d: fb.flash_attn_backward_causal_diag_plain(
        *prescaled(x), T=SPLIT_LEAF, **kw, **d)
    rect = lambda *x, **d: fb.flash_attn_backward_rect(*prescaled(x), **region, **kw, **d)
    rect_plain = lambda *x, **d: fb.flash_attn_backward_rect_plain(*prescaled(x), **region,
                                                                   **kw, **d)
    pb = prescaled(xb)
    P, _, _, loads = fb.tri_partition(SPLIT_S, SPLIT_S, 0, SPLIT_LEAF, 1, 1, QWEN_H, QWEN_D,
                                      fb.sm_count(xb[0].device))
    diag_part = print_partition(f"causal_diag S {SPLIT_S} leaves {SPLIT_LEAF} partition (P {P} "
                                f"per leaf)", loads, QWEN_H, fb.sm_count(xb[0].device))
    for name, kern, plain_fn, lib in (("causal_diag", diag, diag_plain, "flex"),
                                      ("rect", rect, rect_plain, "aten")):
        errs, truth = hold_bwd(torch, f"{name} S {SPLIT_S}", kern, plain_fn, inputs)
        if name == "causal_diag":
            run = lambda: fb.flash_attn_backward_causal_diag(*pb, T=SPLIT_LEAF, **kw)
            ms = cuda_ms(torch, run, iters=3)
            pms = cuda_ms(torch, lambda: fb.flash_attn_backward_causal_diag_plain(
                *pb, T=SPLIT_LEAF, **kw), iters=2, warmup=1)
            lib_ms = flex_diag_bwd(torch, xb, local_truth(torch, "diag", inputs), errs)
            bound = fused_bound(causal_pairs([SPLIT_LEAF] * (SPLIT_S // SPLIT_LEAF)), SPLIT_S,
                                SPLIT_S)
        else:
            run = lambda: fb.flash_attn_backward_rect(*pb, **region, **kw)
            ms = cuda_ms(torch, run, iters=3)
            pms = cuda_ms(torch, lambda: fb.flash_attn_backward_rect_plain(
                *pb, **region, **kw), iters=2, warmup=1)
            lib_ms = library_bwd(torch, "rect", xb, SPLIT_LEAF, SPLIT_LEAF, False,
                                 local_truth(torch, "rect", inputs), errs,
                                 rows=slice(SPLIT_LEAF, SPLIT_S), cols=slice(0, SPLIT_LEAF))
            bound = fused_bound(SPLIT_LEAF * SPLIT_LEAF, SPLIT_LEAF, SPLIT_LEAF)
        how = (f"; the FMA design: {FMA_DESIGN_MS[name]} ms" if name == "causal_diag"
               else f": its dq and dk/dv kernels; the FMA design: {FMA_DESIGN_MS[name]} ms")
        beats_fma_design(name, [ms])
        print(f"[causal bwd] {name} (split_leaf {SPLIT_LEAF}, S {SPLIT_S}) bf16 [{card}]: kernel "
              f"{ms:.3f} ms (CUDA events over whole calls{how}), plain {pms:.3f} ms, library "
              f"({lib}) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        entries[f"flash_bwd_{name}"] = {"max_abs_err": max(errs[n] for n in BWD_NAMES), "ms": ms,
                                       "plain_ms": pms, "library_ms": lib_ms, **bound}
        del truth
    entries["flash_bwd_causal_diag"].update(split_S4096_call_ms=split_ms, partition=diag_part)
    print(f"[causal bwd] the whole split backward at S {SPLIT_S}: {split_ms:.3f} ms [{card}]")
    del inputs, xb, pb
    gc.collect()
    torch.cuda.empty_cache()
    return runs, entries


def local_truth(torch, kind, inputs):
    """The fp32 gradients of the function the diag's and the rect's library
    yardsticks compute: attention over the leaves alone (flex's
    block-diagonal mask) or over the region alone (aten on the sliced
    tensors), each normalised by its own softmax. The split's kernels take
    the global lse and delta instead (their share of the whole causal
    gradient), which no PyTorch call accepts; the work is the same, so the
    yardstick is held to the twin fed its own statistics."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    q, k, v, do, _, lse, lens = inputs(torch.float32)
    kw = dict(softmax_scale=QWEN_D ** -0.5)
    k_p = fb._prescale_k(k, kw["softmax_scale"])
    if kind == "diag":
        o_d, lse_d = ff.flash_attn_forward_causal_diag_plain(q, k, v, lens, T=SPLIT_LEAF, **kw)
        return fb.flash_attn_backward_causal_diag_plain(
            q, k_p, v, do, lse_d, fb.compute_delta(o_d, do, lse_d), lens, T=SPLIT_LEAF, **kw)
    region = dict(row0=SPLIT_LEAF, col0=0, nrows=SPLIT_LEAF, ncols=SPLIT_LEAF)
    rows = slice(SPLIT_LEAF, SPLIT_S)
    o_r, lse_r = ff.flash_attn_forward_rect_plain(q, k, v, lens, **region, **kw)
    lse_full, delta_full = lse.clone(), torch.zeros_like(lse)
    lse_full[:, :, rows] = lse_r
    delta_full[:, :, rows] = fb.compute_delta(o_r, do[:, :, rows], lse_r)
    return fb.flash_attn_backward_rect_plain(q, k_p, v, do, lse_full, delta_full, lens, **region,
                                             **kw)


def flex_diag_bwd(torch, xb, truth, errs):
    """Compiled flex_attention's backward with a block-diagonal causal
    mask_mod (the diag leaves) on the same bf16 tensors: checked against
    `local_truth`, CUDA-event ms of one backward."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    q, k, v, do = (t.contiguous() for t in xb[:4])

    def leaf_mask(b, h, qi, ki):
        return (ki <= qi) & (qi // SPLIT_LEAF == ki // SPLIT_LEAF)

    block_mask = create_block_mask(leaf_mask, None, None, SPLIT_S, SPLIT_S, device=q.device,
                                   BLOCK_SIZE=128)
    flex = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (t.detach().requires_grad_() for t in (q, k, v))
    out = flex(qh, kh, vh, block_mask=block_mask, scale=QWEN_D ** -0.5)
    grads = torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True)
    for n, g, r in zip(BWD_NAMES, grads, truth):
        check_library(torch, f"diag {n}", g, r, errs[n + " plain"])
    return cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True),
                   iters=5)


def qwen_train(torch, card: str):
    """The full-depth Qwen1.5-7B-width trainer at 2 x 2048 (attention over
    2047 tokens: the tri-square backward) and 1 x 8192 (8191: the work
    list), launch counts reset after each warm-up. Returns the launches by
    shape."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    def reset():
        flash_fwd.reset_launches()
        flash_bwd.reset_launches()

    runs = {}
    for batch, seq in QWEN_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        oom = None
        try:
            args, res = run_trainer(torch, card, qwen_train_argv(batch, seq), reset,
                                    f"qwen train {batch} x {seq}")
        except torch.cuda.OutOfMemoryError as e:
            if seq != 8192:
                raise
            oom = (torch.cuda.max_memory_allocated() / 2**30, str(e).splitlines()[0])
        if oom is not None:
            # The memory rule: the same work-list route at 1 x 6144.
            print(f"[qwen train] 1 x {seq} ran out of memory (peak {oom[0]:.2f} GiB [{card}]): "
                  f"{oom[1]}; running 1 x {QWEN_FALLBACK_SEQ}")
            gc.collect()
            torch.cuda.empty_cache()
            seq = QWEN_FALLBACK_SEQ
            args, res = run_trainer(torch, card, qwen_train_argv(batch, seq), reset,
                                    f"qwen train {batch} x {seq}")
        got = bwd_launches(flash_fwd, flash_bwd)
        L, steps = res["config"].n_layers, args.steps
        fwd_route = flash_fwd.forward_route(seq - 1, seq - 1, QWEN_D, 2, causal=True,
                                            static_skip=True)
        want = dict.fromkeys(got, 0)
        want["causal_strip" if fwd_route == "strip" else "flash_fwd"] = 2 * L * steps
        want["bwd_tri_square" if seq == 2048 else "bwd_worklist"] = L * steps
        print(f"[qwen train] {batch} x {seq} launches: {got}")
        if got != want:
            raise AssertionError(f"qwen {batch} x {seq} training launches {got} != {want}")
        runs[f"{batch} x {seq}"] = got
    return runs


def phase_causal_bwd(torch, card: str, mma=None):
    """Phase 12: the causal backward schedules (`mma`: mma_build_report's
    table, made here when not given). Returns (launches by run, kernel
    entries)."""
    from fa2_triton_tpu_torch.ops import flash_bwd

    t0 = time.perf_counter()
    if any(flash_bwd.SCHEDULE_LAUNCHES.values()):
        raise AssertionError(f"phases 1-11 launched a backward schedule kernel: "
                             f"{flash_bwd.SCHEDULE_LAUNCHES}")
    print("[causal bwd] phases 1-11 (Mistral-7B-v0.3 widths) launched no backward schedule "
          f"kernel: {dict(flash_bwd.SCHEDULE_LAUNCHES)}")
    mma = mma or mma_build_report()
    runs, entries = causal_bwd_kernels(torch, card)
    entries["flash_bwd_tri_square"]["build"] = mma["bwd_tri_mma_kernel"]
    entries["flash_bwd_worklist"]["build"] = mma["bwd_wl_mma_kernel"]
    runs["train"] = qwen_train(torch, card)
    print(f"[causal bwd] phase 12 took {time.perf_counter() - t0:.1f} s")
    return runs, entries


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import fa2_triton_tpu_torch  # noqa: F401  (raises beside a lone chip_smoke.py)

    if not os.path.abspath(fa2_triton_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"fa2_triton_tpu_torch imported from {fa2_triton_tpu_torch.__file__}, "
                           f"not from this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card)

    phase_build()
    mma = mma_build_report()
    decode_build = decode_build_report()
    with torch.inference_mode():
        kernels = phase_kernels(torch)
        kernels["flash_fwd"]["build"] = mma["flash_fwd_mma_kernel"]
        torch.cuda.empty_cache()
        model, cfg, reqs, prompts, launches = phase_serve(torch, card)
        phase_check(torch, model, cfg, reqs, prompts)
        torch.cuda.empty_cache()
        served = phase_serve_modes(torch, card, model, cfg, reqs, prompts)
    del model, reqs  # the served model and its cache make way for training
    gc.collect()
    torch.cuda.empty_cache()
    kernels.update(phase_bwd_kernels(torch))
    torch.cuda.empty_cache()
    bias_launches, kernels["flash_bwd_dbias"] = phase_bias(torch)
    torch.cuda.empty_cache()
    phase_train_grads(torch)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    varlen_launches, varlen_kernels = phase_varlen(torch, card)
    for name in VARLEN_KERNEL_NAMES:
        varlen_kernels[name]["build"] = mma[VARLEN_KERNEL_NAMES[name]]
    torch.cuda.empty_cache()
    bs_launches, bs_kernels = phase_blocksparse(torch)
    gc.collect()
    torch.cuda.empty_cache()
    dropout_runs, dropout_kernels = phase_dropout(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    sched_runs, sched_kernels = phase_schedules(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    bwd_runs, bwd_kernels = phase_causal_bwd(torch, card, mma)

    if any(name == "jax" or name.startswith(("jax.", "fa2_triton_tpu.")) for name in sys.modules):
        raise RuntimeError("the port imported jax or the JAX package")
    table = {"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_fwd.py:56",
         "also_replaces": "fa2_triton_tpu/ops/flash_fwd.py:454",
         "launches": launches["flash_fwd"], "launches_train": train_launches["flash_fwd"],
         "launches_bias_path": bias_launches["flash_fwd"], **kernels["flash_fwd"]},
        {"name": "decode", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/decode.cuh",
         "replaces": "fa2_triton_tpu/ops/decode.py:158",
         "launches": launches["decode"], **kernels["decode"], "build": decode_build},
        {"name": "decode_quant", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/decode.cuh",
         "replaces": "fa2_triton_tpu/ops/decode.py:74",
         "launches": sum(n for run in served.values() for v, n in run.items() if "contiguous" in v),
         "launches_by_run": {r: v for r, v in served.items() if r.startswith("contiguous")},
         **kernels["decode_quant"]},
        {"name": "paged_decode", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/decode.cuh",
         "replaces": "fa2_triton_tpu/ops/decode.py:273",
         "also_replaces": "fa2_triton_tpu/ops/decode.py:280",
         "launches": sum(n for run in served.values() for v, n in run.items() if "paged" in v),
         "launches_by_run": {r: v for r, v in served.items() if r.startswith("paged")},
         **kernels["paged_decode"]},
        {"name": "flash_bwd_dq", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_bwd.py:159",
         "also_replaces": "fa2_triton_tpu/ops/flash_bwd.py:602 (B12), fa2_triton_tpu/ops/flash_bwd.py:376 (B2)",
         "launches": train_launches["flash_bwd_dq"], **kernels["flash_bwd_dq"]},
        {"name": "flash_bwd_dkdv", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_bwd.py:263",
         "also_replaces": "fa2_triton_tpu/ops/flash_bwd.py:602 (B12), fa2_triton_tpu/ops/flash_bwd.py:376 (B2)",
         "launches": train_launches["flash_bwd_dkdv"], **kernels["flash_bwd_dkdv"]},
        {"name": "flash_bwd_dbias", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_bwd.py:1357",
         "launches": bias_launches["flash_bwd_dbias"], **kernels["flash_bwd_dbias"],
         "dropout": dropout_kernels["flash_bwd_dbias_dropout"], "build": mma["dbias_mma_kernel"]},
    ]}
    for name, line in (("varlen_fwd", 233), ("varlen_dq", 385), ("varlen_dkdv", 454)):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/varlen.cu",
            "replaces": f"fa2_triton_tpu/ops/varlen.py:{line}",
            "launches": varlen_launches[name], "launches_blocksparse": bs_launches[name],
            **varlen_kernels[name],
            "blocksparse": {k: bs_kernels[name][k] for k in
                            ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}})
    layer, dense = dropout_runs["layer"], dropout_runs["flash_attn_func"]
    for name, source, replaces, key in (
            ("flash_fwd_dropout", "flash_fwd.cu", "flash_fwd.py:56", "flash_fwd"),
            ("flash_bwd_dropout_dq", "flash_bwd.cu", "flash_bwd.py:159", "flash_bwd_dq"),
            ("flash_bwd_dropout_dkdv", "flash_bwd.cu", "flash_bwd.py:263", "flash_bwd_dkdv")):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"fa2_triton_tpu_torch/csrc/{source}",
            "replaces": f"fa2_triton_tpu/ops/{replaces}",
            "also_replaces": ("fa2_triton_tpu/ops/flash_fwd.py:454 (B9, dropout l.546-554)"
                              if key == "flash_fwd" else
                              "fa2_triton_tpu/ops/flash_bwd.py:45 (_recompute_p_and_ds, dropout "
                              "l.133-156, in B2 / B3 / B12)"),
            "launches": layer[key], "launches_flash_attn_func": dense[key],
            "launches_bias_path": dropout_runs["bias path"][key], **dropout_kernels[name]})
    for name, line in (("varlen_fwd", 233), ("varlen_dq", 385), ("varlen_dkdv", 454)):
        table["kernels"].append({
            "name": f"{name}_dropout", "route": "cuda",
            "source": "fa2_triton_tpu_torch/csrc/varlen.cu",
            "replaces": f"fa2_triton_tpu/ops/varlen.py:{line}",
            "also_replaces": "fa2_triton_tpu/ops/varlen.py:214 (_packed_dropout_bits)",
            "launches": dropout_runs["varlen"][name], **dropout_kernels[f"{name}_dropout"]})
    for name, source, replaces, also, launches, extra in (
            ("flash_fwd_causal_strip", "flash_fwd.cu", "flash_fwd.py:640",
             "fa2_triton_tpu/ops/flash_fwd.py:779 (flash_attn_forward_causal_strip)",
             sched_runs[f"flash_attn_func {STRIP_SEQ} / {STRIP_SEQ}"]["causal_strip"],
             {"launches_shifted_2048_4096":
              sched_runs[f"flash_attn_func {SHIFT_SQ} / {SHIFT_SK}"]["causal_strip"]}),
            ("flash_fwd_causal_diag", "flash_fwd.cu", "flash_fwd.py:454",
             "diag_stride / leaf_subs mode of fa2_triton_tpu/ops/flash_fwd.py:969 "
             "(flash_attn_forward_causal_diag)", sched_runs["train"]["causal_diag"],
             {"launches_flash_attn_func": sched_runs["flash_attn_func S 4096"]["causal_diag"]}),
            ("flash_fwd_rect", "flash_fwd.cu", "flash_fwd.py:1041",
             "fa2_triton_tpu/ops/flash_fwd.py:434 (_fwd_kernel_nobias on a rectangle)",
             sched_runs["flash_attn_forward_rect"]["rect"], {}),
            ("flash_fwd_rect_merge", "flash_fwd.cu", "flash_fwd.py:447",
             "fa2_triton_tpu/ops/flash_fwd.py:367-381 (the merge finaliser), driven by "
             "_causal_split_forward l.1165", sched_runs["train"]["rect_merge"],
             {"launches_flash_attn_func": sched_runs["flash_attn_func S 4096"]["rect_merge"]})):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"fa2_triton_tpu_torch/csrc/{source}",
            "replaces": f"fa2_triton_tpu/ops/{replaces}", "also_replaces": also,
            "launches": launches, **extra, **sched_kernels[name]})
    train_runs = bwd_runs["train"]
    long_run = next(r for name, r in train_runs.items() if name.startswith("1 x"))
    for name, source, replaces, also, launches, extra in (
            ("flash_bwd_tri_square", "flash_bwd_tri.cu", "flash_bwd.py:845",
             "fa2_triton_tpu/ops/flash_bwd.py:985 (flash_attn_backward_tri_square)",
             train_runs["2 x 2048"]["bwd_tri_square"],
             {"launches_flash_attn_backward": bwd_runs["tri_square"]["bwd_tri_square"]}),
            ("flash_bwd_causal_diag", "flash_bwd_tri.cu", "flash_bwd.py:1060",
             "the diag_stride / leaf_subs mode of fa2_triton_tpu/ops/flash_bwd.py:845, driven by "
             "_causal_split_backward l.1278", bwd_runs["split"]["bwd_causal_diag"], {}),
            ("flash_bwd_rect", "flash_bwd.cu", "flash_bwd.py:1138",
             "fa2_triton_tpu/ops/flash_bwd.py:376 (_bwd_fused_kernel on a rectangle), driven by "
             "_causal_split_backward l.1278", bwd_runs["split"]["bwd_rect"], {}),
            ("flash_bwd_worklist", "flash_bwd_wl.cu", "flash_bwd.py:1849",
             "fa2_triton_tpu/ops/flash_bwd.py:1986 (flash_attn_backward_fused_wl), schedule "
             "build_causal_bwd_worklist l.1779", long_run["bwd_worklist"],
             {"launches_flash_attn_backward": bwd_runs["worklist"]["bwd_worklist"],
              "train_shape": next(n for n in train_runs if n.startswith("1 x"))})):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"fa2_triton_tpu_torch/csrc/{source}",
            "replaces": f"fa2_triton_tpu/ops/{replaces}", "also_replaces": also,
            "launches": launches, **extra, **bwd_kernels[name]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
