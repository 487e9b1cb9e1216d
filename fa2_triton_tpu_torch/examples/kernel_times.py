"""Device time of each attention kernel at Mistral-7B-v0.3 attention widths
(32 / 8 heads, head_dim 128, bf16), one JSON line on stdout:

  * the dense forward, dq and dk/dv kernels at B 2 x S 2048, causal;
  * the causal forward at B 1 x S 4096 by its default route (the split
    schedule: the diag and one merged rectangle) and by the generic kernel;
  * the packed varlen forward, dq and dk/dv kernels on the packed batch of
    `chip_smoke.py`'s phase 8 (documents of log-uniform length 64-4096 from
    `numpy.random.default_rng(0)`, packed into T <= 16384 at block 128), and
    the whole packed backward call by CUDA events.

    python fa2_triton_tpu_torch/examples/kernel_times.py [--dropout P] [--root DIR]

Times come from torch.profiler (device time per launch, averaged over
--iters calls after a warm-up), the S 4096 forwards' from CUDA events over
whole calls (the split's two launches may share one kernel name). `--root`
times the package of another checkout instead of the one holding this file
(for example a parent commit unpacked with `git archive`), so that two
versions can be run in turns within one machine allocation; `--dropout` is
then only for versions that take it. Run it by its path, not with -m, so
that the package is imported from the root. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


# The packed kernels under their names in either version: the FMA kernels
# (every input type before the tensor-core ones; fp32 since) and the
# tensor-core ones of bf16 / fp16 inputs. Times are filed under the first.
VARLEN_FWD_NAMES = (("varlen_fwd_kernel", "varlen_mma_fwd_kernel"),)
VARLEN_BWD_NAMES = (("varlen_dq_kernel", "varlen_mma_dq_kernel"),
                    ("varlen_dkdv_kernel", "varlen_mma_dkdv_kernel"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dropout", type=float, default=0.0, help="dropout_p (seed 1234567)")
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), "..", ".."),
                    help="checkout whose package is timed (default: this one)")
    ap.add_argument("--iters", type=int, default=10)
    return ap.parse_args(argv)


def device_ms(torch, fn, names, iters):
    """Profiler device time per call of each kernel whose name contains one
    of `names` (each launches once per call of `fn`); each kernel must show
    exactly `iters` launches, or the time would be a partial record's. A
    name may be a tuple of the names one kernel has in different versions
    (the time is filed under its first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        alts = name if isinstance(name, tuple) else (name,)
        name = alts[0]
        hits = [e for e in prof.key_averages() if any(a in e.key for a in alts)]
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in hits)
        n = sum(e.count for e in hits)
        if not (us > 0 and n == iters):
            raise RuntimeError(f"the profiler recorded {n} launches of {name} in {iters} calls, "
                               f"{us:.1f} us of device time")
        out[name] = us / iters / 1e3
    return out


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
    drop = dict(dropout_p=args.dropout, dropout_seed=1234567) if args.dropout > 0 else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S, Hq, Hkv, D = 2, 2048, 32, 8, 128
    bf = lambda x: x.to(torch.bfloat16).transpose(1, 2)  # noqa: E731
    q, do = (bf(torch.randn((B, S, Hq, D), generator=gen, device=dev) * sd) for sd in (0.5, 1.0))
    k, v = (bf(torch.randn((B, S, Hkv, D), generator=gen, device=dev) * 0.5) for _ in range(2))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5, **drop)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
    out = {"package": os.path.dirname(flash_fwd.__file__), "dropout_p": args.dropout,
           "device": torch.cuda.get_device_name(0)}
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
    for name, skip in (("split_fwd_1x4096", True), ("generic_fwd_1x4096", False)):
        out[f"{name}_ms"] = events_ms(torch, lambda: flash_fwd.flash_attn_forward(
            q1, k1, v1, lens1, static_skip=skip, **kw), args.iters)
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
