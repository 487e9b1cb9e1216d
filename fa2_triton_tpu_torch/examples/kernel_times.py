"""Device time of each attention kernel at Mistral-7B-v0.3 attention widths
(32 / 8 heads, head_dim 128, bf16), one JSON line on stdout:

  * the dense forward, dq and dk/dv kernels at B 2 x S 2048, causal;
  * the causal forward at B 1 x S 4096 by its default route (the split
    schedule: the diag and one merged rectangle) and by the generic kernel;
  * the packed varlen forward, dq and dk/dv kernels on the packed batch of
    `chip_smoke.py`'s phase 8 (documents of log-uniform length 64-4096 from
    `numpy.random.default_rng(0)`, packed into T <= 16384 at block 128), and
    the whole packed backward call by CUDA events;
  * the decode kernel (B5 / B6, `decode_kernel` in every version) at
    `chip_smoke.py`'s phase 2 shape (8 slots, 32 / 8 heads, S_max 4096, its
    kv lengths 1-4096), contiguous and in its shuffled page pools of 128 and
    512 rows, caches in bf16, int8 and fp8 (`decode_<layout> <cache>[ page
    N]`): its device time and the whole call's (`..._call_ms`, CUDA
    events); aten varlen flash on the gathered bf16 rows the same two ways
    (`decode_aten`);
  * with `--only dbias`: the bias gradient kernel (B4; `dbias_kernel`, FMA,
    or `dbias_mma_kernel`, tensor cores) and the dq / dk/dv kernels' bias
    instantiations at `chip_smoke.py`'s phase 6 shape (B 2 x S 2047, a
    trainable [1, 32, S, S] bf16 bias, causal);
  * with `--only serve`: `chip_smoke.py`'s serve phase (its 16 requests,
    its four serve modes, Mistral-7B-v0.3 widths, random bf16 weights from
    seed 0), with the mean and median ms per decode step (host clock to the
    device's end), and the host us per decode call at a tiny cache
    (`decode_host_us`);
  * with `--only chunk`: one prefill chunk of `chip_smoke.py`'s phase 13
    (512 queries at cache length 1024) through `chunk_prefill_step` over
    the contiguous cache and `paged_chunk_prefill_step` over a page pool
    of 128 rows, at Mistral-7B-v0.3 widths, full depth, in turns: ms per
    dispatch (host clock to the device's end), and the device time and
    count of the kernels of one dispatch (torch.profiler, summed); then the
    token choice on one decode step's [8, 32768] fp32 logits (rows 4-7
    sampled), sampler against greedy, the same ways;
  * with `--only spec`: the cached attention of speculative decoding
    (`flash_attn_with_kv_cache`, B1) at widths 1 and gamma + 1
    (`chip_smoke.py`'s SPEC_WIDTHS) over 1024, 2048 and 4096 cached rows,
    bf16, B 1: its device time, aten flash's (causal, bottom-right aligned;
    every kernel of its call, summed) and the bound; then one full-depth
    Mistral-7B-v0.3 target step (`forward_with_cache`, random bf16 weights
    from seed 0) at the same widths after those cache lengths, in turns: ms
    per step (host clock to the device's end), and one step's device time
    and launches;
  * with `--only routes`: the full-depth trainers whose routes the card's
    tuning table (`ops/tables/tuning_<chip>.json`) changes, `chip_smoke.py`'s
    Mistral-7B-v0.3 1 x 4096 (the forward: split -> strip on the H100) and
    Qwen1.5-7B 1 x 8192 (the backward: work list -> the dq + dk/dv pair),
    each with FA2_DISABLE_TUNING_TABLE=1 (the prior's routes) and without
    it, in turns prior, table, table, prior: seconds per step (host clock
    to the device's end), tokens/s of the median step, peak memory and the
    launches by route.

    python fa2_triton_tpu_torch/examples/kernel_times.py [--dropout P] [--root DIR]
        [--only decode|dbias|serve|chunk|spec|routes]

Times come from torch.profiler (device time per launch, averaged over
--iters calls after a warm-up), the S 4096 forwards' from CUDA events over
whole calls (the split's two launches may share one kernel name). `--root`
times the package of another checkout instead of the one holding this file
(for example a parent commit unpacked with `git archive`), so that two
versions can be run in turns within one machine allocation; `--dropout` is
then only for versions that take it. The decode shape, the pools and the
served traffic come from the `chip_smoke.py` beside this checkout's
package, whichever package is timed. `--only decode` times the decode
variants alone, `--only dbias` the bias path's backward kernels (its shape
from `chip_smoke.py` too), `--only serve` the serve modes, `--only chunk`
the chunk dispatch and the sampler, `--only spec` the speculative steps,
`--only routes` the trainers with and without the tuning table. The
default run's split forward is timed with FA2_DISABLE_TUNING_TABLE=1 (the
prior routes it to the split; a checkout without a table ignores the
variable). Run it by its
path, not with -m, so that the package is imported from the root. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")

# The packed kernels under their names in either version: the FMA kernels
# (every input type before the tensor-core ones; fp32 since) and the
# tensor-core ones of bf16 / fp16 inputs. Times are filed under the first.
VARLEN_FWD_NAMES = (("varlen_fwd_kernel", "varlen_mma_fwd_kernel"),)
VARLEN_BWD_NAMES = (("varlen_dq_kernel", "varlen_mma_dq_kernel"),
                    ("varlen_dkdv_kernel", "varlen_mma_dkdv_kernel"))
# The bias path's backward kernels, filed as `bias_<first name>`.
DBIAS_NAMES = (("dbias_kernel", "dbias_mma_kernel"), ("dq_kernel", "dq_mma_kernel"),
               ("dkdv_kernel", "dkdv_mma_kernel"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dropout", type=float, default=0.0, help="dropout_p (seed 1234567)")
    ap.add_argument("--root", default=REPO,
                    help="checkout whose package is timed (default: this one)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", choices=("decode", "dbias", "serve", "chunk", "spec", "routes"),
                    help="time only these")
    return ap.parse_args(argv)


def device_ms(torch, fn, names, iters, attempts=3):
    """Profiler device time per call of each kernel whose name contains one
    of `names` (each launches once per call of `fn`); each kernel must show
    exactly `iters` launches, or the time would be a partial record's (the
    profiler now and then misses one: the window is recorded again, up to
    `attempts` times). A name may be a tuple of the names one kernel has in
    different versions (the time is filed under its first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out, missed = {}, None
        for name in names:
            alts = name if isinstance(name, tuple) else (name,)
            name = alts[0]
            hits = [e for e in prof.key_averages() if any(a in e.key for a in alts)]
            us = sum(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) for e in hits)
            n = sum(e.count for e in hits)
            if not (us > 0 and n == iters):
                missed = (f"the profiler recorded {n} launches of {name} in {iters} calls, "
                          f"{us:.1f} us of device time")
            out[name] = us / iters / 1e3
        if missed is None:
            return out
    raise RuntimeError(f"{missed} ({attempts} windows)")


def events_ms(torch, fn, iters):
    """CUDA-event ms per call of `fn` over `iters` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def doc_lengths(lo=64, hi=4096, t_max=16384, block=128):
    rng = np.random.default_rng(0)
    lens, T = [], 0
    while True:
        n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        ext = -(-n // block) * block
        if T + ext > t_max:
            return lens
        lens.append(n)
        T += ext


def smoke_module():
    """`chip_smoke.py` of the checkout holding this file, imported as a
    module (its phases run only from its main): the one definition of the
    decode shape, the page pools and the served traffic. Its functions
    import the package that `--root` put first on sys.path."""
    path = os.path.join(REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decode_times(torch, iters):
    """{variant: kernel ms, variant_call_ms: call ms} of the decode kernel,
    and aten varlen flash on the gathered bf16 rows (`decode_aten`: device
    time of its kernels; `_call_ms`: CUDA events)."""
    from fa2_triton_tpu_torch.ops import decode
    from fa2_triton_tpu_torch.ops.quant import quantize_tensor

    smoke = smoke_module()
    lens_list = list(smoke.DECODE_LENS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    slots, Hq, Hkv, D, S_max = len(lens_list), 32, 8, 128, 4096
    q = (torch.randn((slots, Hq, D), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    k32, v32 = (torch.randn((slots, Hkv, S_max, D), generator=gen, device=dev) * 0.5
                for _ in range(2))
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    stored = {"bf16": (k32.to(torch.bfloat16), v32.to(torch.bfloat16), None, None)}
    for name, qd in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        (kq, ks), (vq, vs) = (quantize_tensor(x, qd) for x in (k32, v32))
        stored[name] = (kq, vq, *(s.transpose(-1, -2).contiguous() for s in (ks, vs)))
    del k32, v32
    kw = dict(softmax_scale=D ** -0.5)
    lib_fwd, _, _ = smoke.library_attention(
        torch, q, *(smoke.tight(torch, x.transpose(1, 2), lens_list) for x in stored["bf16"][:2]),
        [1] * slots, lens_list, False, D ** -0.5)
    with contextlib.redirect_stdout(sys.stderr):   # its kernel list
        out = {"decode_aten": smoke.library_mean_ms(torch, lib_fwd, iters)}
    out["decode_aten_call_ms"] = events_ms(torch, lib_fwd, iters)
    for name, c in stored.items():
        runs = {f"decode_contiguous {name}":
                lambda c=c: decode.decode_attention(q, c[0], c[1], lens, *c[2:], **kw)}
        for page in smoke.DECODE_PAGES:
            pools, tables = smoke.page_pool(torch, c, lens_list, page, seed=page, fill=0.0)
            runs[f"decode_paged {name} page {page}"] = (
                lambda p=pools, t=tables: decode.paged_decode_attention(q, p[0], p[1], t, lens,
                                                                       *p[2:], **kw))
        for what, fn in runs.items():
            out[what] = device_ms(torch, fn, ("decode_kernel",), iters)["decode_kernel"]
            out[f"{what}_call_ms"] = events_ms(torch, fn, iters)
    return out


def dbias_times(torch, iters, drop):
    """Device ms per call of the bias path's backward kernels (DBIAS_NAMES)
    at phase 6's shape and inputs (`chip_smoke.attn_inputs`, seed 3), with
    `drop`'s dropout; the bound of the dbias kernel beside them."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    smoke = smoke_module()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    S, D = smoke.BWD_SEQ, 128
    bf = lambda x: x.to(torch.bfloat16).transpose(1, 2)  # noqa: E731
    q32, k32, v32, do32, lens = smoke.attn_inputs(torch, gen, dev, S)
    q, k, v, do = (bf(x) for x in (q32, k32, v32, do32))
    B, Hq, Hkv = q.shape[0], q.shape[1], k.shape[1]
    bias = torch.randn((1, Hq, S, S), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(causal=True, softmax_scale=D ** -0.5, **drop)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, 0, 0, bias, **kw)
    ms = device_ms(torch, lambda: flash_bwd.flash_attn_backward(
        q, k, v, do, o, lse, lens, 0, 0, bias, compute_dbias=True, **kw), DBIAS_NAMES, iters)
    return {**{f"bias_{n}": t for n, t in ms.items()},
            "dbias_bound": smoke.dbias_bound(B, Hq, Hkv, S, D)}


def serve_times(torch):
    """ms per decode step of each serve mode of `chip_smoke.py` (its serve
    phase, checks included; its lines go to stderr), and the decode
    wrapper's host time per call."""
    import time

    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params
    from fa2_triton_tpu_torch.ops import decode

    smoke = smoke_module()
    dev = torch.device("cuda")
    q = torch.zeros((8, 32, 128), device=dev, dtype=torch.bfloat16)
    kv = torch.zeros((8, 8, 1024, 128), device=dev, dtype=torch.bfloat16)
    lens = torch.full((8,), 100, dtype=torch.int32, device=dev)
    for _ in range(20):
        decode.decode_attention(q, kv, kv, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        decode.decode_attention(q, kv, kv, lens)
    torch.cuda.synchronize()
    out = {"decode_host_us": (time.perf_counter() - t0) / 500 * 1e6}
    cfg = preset_config("mistral-7b-v0.3", torch.bfloat16)
    model = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = smoke.served_prompts(cfg)
    card = torch.cuda.get_device_name(0)
    with torch.inference_mode(), contextlib.redirect_stdout(sys.stderr):
        for what in smoke.SERVE_MODES:
            step_s = smoke.serve(torch, model, cfg, prompts, card, what)[3]
            out[f"{what} ms_per_step"] = 1e3 * float(np.mean(step_s))
            out[f"{what} median_ms_per_step"] = 1e3 * float(np.median(step_s))
            out[f"{what} steps"] = len(step_s)
    return out


def busy(torch, fn):
    """(host ms to the device's end, device ms of every kernel, kernel
    launches) of one call of `fn`, after a warm-up call."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if (getattr(e, "self_device_time_total", None) or
                  getattr(e, "self_cuda_time_total", 0)) > 0]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in events)
    return wall, us / 1e3, sum(e.count for e in events)


def chunk_times(torch, iters):
    """`--only chunk` (see the module docstring)."""
    import time

    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params, llama
    from fa2_triton_tpu_torch.runtime import (
        KVCacheConfig, PagedCacheConfig, PagedKVCache, init_cache, sampling,
    )

    smoke = smoke_module()
    dev = torch.device("cuda")
    cfg = preset_config("mistral-7b-v0.3", torch.bfloat16)
    model = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    C, cache_len = smoke.CHUNK, smoke.CHUNK_Q_OFF
    kw = dict(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_slots=8,
              max_seq=4096, compute_dtype=cfg.dtype)
    kcfg, pcfg = KVCacheConfig(**kw), PagedCacheConfig(page_size=128, n_pages=257, **kw)
    caches, pool = init_cache(kcfg, device=dev), PagedKVCache(pcfg, device=dev)
    pool.ensure_capacity(0, cache_len + C)
    tok = torch.randint(0, cfg.vocab_size, (1, C), generator=torch.Generator().manual_seed(1))
    tok = tok.to(dev)
    runs = {
        "chunk_contiguous": lambda: llama.chunk_prefill_step(model, tok, C, cache_len, caches,
                                                             kcfg, 0),
        "chunk_paged": lambda: llama.paged_chunk_prefill_step(
            model, tok, C, cache_len, pool.pools, pool.tables_device(), 0, pcfg),
    }
    logits = torch.randn((8, cfg.vocab_size), generator=torch.Generator().manual_seed(2)) * 3
    logits = logits.to(dev)
    samp = ([0.0] * 4 + [0.8] * 4, [0] * 4 + [50] * 4, [1.0] * 4 + [0.95] * 4,
            list(range(8)), [5] * 8)
    picks = {"choice_sampler": lambda: sampling.sample_tokens_with_logprobs(logits, *samp),
             "choice_greedy": lambda: sampling.greedy_tokens_with_logprobs(logits)}
    out = {}
    with torch.inference_mode():
        for group in (runs, picks):
            names = list(group)
            ms = {n: [] for n in names}
            for r in range(iters):
                for n in (names if r % 2 == 0 else names[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    group[n]()
                    torch.cuda.synchronize()
                    ms[n].append((time.perf_counter() - t0) * 1e3)
            for n in names:
                wall, dev_ms, launches = busy(torch, group[n])
                out[n] = {"ms": ms[n], "median_ms": float(np.median(ms[n])),
                          "profiled_call_ms": wall, "device_ms": dev_ms, "launches": launches}
    return out


SPEC_KV = (1024, 2048, 4096)


def spec_times(torch, iters):
    """`--only spec` (see the module docstring): `chip_smoke.verify_call`
    and `chip_smoke.step_widths_ms` over SPEC_KV (their lines go to
    stderr)."""
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params, llama

    smoke = smoke_module()
    dev = torch.device("cuda")
    out = {}
    with torch.inference_mode(), contextlib.redirect_stdout(sys.stderr):
        for kv in SPEC_KV:
            for name, e in smoke.verify_call(torch, kv, iters).items():
                out[f"b1 {name} kv {kv}"] = e
        cfg = preset_config("mistral-7b-v0.3", torch.bfloat16)
        model = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        top = smoke.SPEC_MAX_SEQ - smoke.SPEC_WIDTHS[-1]
        toks = torch.randint(0, cfg.vocab_size, (1, top), generator=torch.Generator().manual_seed(1))
        caches, attn = smoke.prefilled(torch, model, cfg, toks[0].tolist())   # the rows read below
        toks = toks.to(dev)
        for kv in (SPEC_KV[0], SPEC_KV[1], top):
            ms = smoke.step_widths_ms(torch, model, cfg, caches, kv, toks, iters)
            for S, v in ms.items():
                wall, dev_ms, launches = busy(torch, lambda S=S, kv=kv: llama.forward_with_cache(
                    model, toks[:, :S], cfg, caches, kv, attn))
                out[f"target step width {S} after {kv}"] = {
                    "ms": v, "median_ms": float(np.median(v)), "profiled_call_ms": wall,
                    "device_ms": dev_ms, "launches": launches}
    return out


def route_trainer_times(torch):
    """`--only routes` (see the module docstring), through
    `chip_smoke.run_trainer` (its lines go to stderr)."""
    import gc
    import subprocess

    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    smoke = smoke_module()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    def reset():
        flash_fwd.reset_launches()
        flash_bwd.reset_launches()

    out = {}
    for name, argv in (("mistral-7b-v0.3 1 x 4096", smoke.LONG_TRAIN_ARGV),
                       ("qwen1.5-7b 1 x 8192", smoke.qwen_train_argv(1, 8192))):
        for which in ("prior", "table", "table", "prior"):
            if which == "prior":
                os.environ["FA2_DISABLE_TUNING_TABLE"] = "1"
            try:
                with contextlib.redirect_stdout(sys.stderr):
                    _, res = smoke.run_trainer(torch, card, argv, reset, f"routes {name} {which}")
            finally:
                os.environ.pop("FA2_DISABLE_TUNING_TABLE", None)
            out.setdefault(f"{name} {which}", []).append({
                "step_s": res["step_s"], "tokens_per_s": res["tokens_per_s"],
                "peak_gib": res["peak_bytes"] / 2**30,
                "launches": smoke.bwd_launches(flash_fwd, flash_bwd)})
            del res
            gc.collect()
            torch.cuda.empty_cache()
    out["card"] = card
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd, varlen

    if not os.path.abspath(flash_fwd.__file__).startswith(root + os.sep):
        raise RuntimeError(f"fa2_triton_tpu_torch came from {flash_fwd.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"package": os.path.dirname(flash_fwd.__file__), "dropout_p": args.dropout,
           "device": torch.cuda.get_device_name(0)}
    drop = dict(dropout_p=args.dropout, dropout_seed=1234567) if args.dropout > 0 else {}
    if args.only:
        out.update(decode_times(torch, args.iters) if args.only == "decode" else
                   dbias_times(torch, args.iters, drop) if args.only == "dbias" else
                   chunk_times(torch, args.iters) if args.only == "chunk" else
                   spec_times(torch, args.iters) if args.only == "spec" else
                   route_trainer_times(torch) if args.only == "routes" else
                   serve_times(torch))
        print(json.dumps(out))
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S, Hq, Hkv, D = 2, 2048, 32, 8, 128
    bf = lambda x: x.to(torch.bfloat16).transpose(1, 2)  # noqa: E731
    q, do = (bf(torch.randn((B, S, Hq, D), generator=gen, device=dev) * sd) for sd in (0.5, 1.0))
    k, v = (bf(torch.randn((B, S, Hkv, D), generator=gen, device=dev) * 0.5) for _ in range(2))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5, **drop)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
    out.update(device_ms(torch, lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw),
                         ("flash_fwd",), args.iters))   # flash_fwd_kernel or flash_fwd_mma_kernel
    out.update(device_ms(torch, lambda: flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw),
                         ("dq_", "dkdv_"), args.iters))   # dq_kernel / dq_mma_kernel, dk/dv alike
    del q, k, v, do, o, lse

    S1 = 4096
    g3 = torch.Generator(device=dev).manual_seed(3)
    q1 = bf(torch.randn((1, S1, Hq, D), generator=g3, device=dev) * 0.5)
    k1, v1 = (bf(torch.randn((1, S1, Hkv, D), generator=g3, device=dev) * 0.5) for _ in range(2))
    lens1 = torch.tensor([[S1, S1]], dtype=torch.int32, device=dev)
    os.environ["FA2_DISABLE_TUNING_TABLE"] = "1"   # the prior's route at S 4096: the split
    for name, skip in (("split_fwd_1x4096", True), ("generic_fwd_1x4096", False)):
        out[f"{name}_ms"] = events_ms(torch, lambda: flash_fwd.flash_attn_forward(
            q1, k1, v1, lens1, static_skip=skip, **kw), args.iters)
    os.environ.pop("FA2_DISABLE_TUNING_TABLE")
    del q1, k1, v1

    docs = doc_lengths()
    g2 = torch.Generator(device=dev).manual_seed(4)
    padded = [torch.randn((len(docs), 4096, h, D), generator=g2, device=dev) * sd
              for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    packed, starts, _ = varlen.pack_padded_batch(padded, docs, align=128)
    del padded
    qp, kp, vp, dop = (bf(x) for x in packed)
    pkw = dict(causal=True, softmax_scale=D ** -0.5, block_q=128, block_kv=128, **drop)
    seg = ([int(s) for s in starts], docs, docs)
    op, lsep = varlen.flash_attn_varlen_forward(qp, kp, vp, *seg, **pkw)
    out.update(device_ms(torch, lambda: varlen.flash_attn_varlen_forward(qp, kp, vp, *seg, **pkw),
                         VARLEN_FWD_NAMES, args.iters))
    out.update(device_ms(
        torch, lambda: varlen.flash_attn_varlen_backward(qp, kp, vp, dop, op, lsep, *seg, **pkw),
        VARLEN_BWD_NAMES, args.iters))
    out["varlen_bwd_call_ms"] = events_ms(torch, lambda: varlen.flash_attn_varlen_backward(
        qp, kp, vp, dop, op, lsep, *seg, **pkw), args.iters)
    del qp, kp, vp, dop, op, lsep
    out.update(decode_times(torch, args.iters))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
