"""Route micro-sweeps on the card (PyTorch port of
`fa2_triton_tpu.ops.microsweep`), and the sweep that writes a chip's table.

The JAX package sweeps tile configs per (chip, kind, head_dim, bucket).
On the card the tiles are compile-time (`ops/tuning.py`), so its tile kinds
(`fwd`, `fused_bwd`, `strip_*`, `diag_*`, `rect_*`) have no candidates
here; what a table can choose is the schedule, `fwd_route` and `bwd_route`
(variant `g<group>`). Their candidates are the routes whose prior gates
pass at the key's sweep shape (`sweep_shape`): causal bf16, B
max(1, 4096 // bucket), 32 query heads, 32 / group kv heads, length
bucket - 1. A candidate is timed through the port's launcher with its
route forced (`flash_fwd.flash_attn_forward` / `flash_bwd.
flash_attn_backward`, `route=`) by `utils/benchmarking.device_time` (CUDA
events); one that fails to launch or runs out of memory is skipped and
printed.

The decision rule (`decide`): the fastest median wins only if it beats the
prior's route (the route the call takes with no table) by more than the
larger max - min spread of the two; otherwise the prior's route is kept.

Sweep a chip and write its table (run on the card):

    python -m fa2_triton_tpu_torch.ops.microsweep --out DIR [--report FILE]
        [--kinds fwd_route bwd_route] [--head-dims 64 128 256]
        [--buckets 512 1024 2048 4096 8192 16384] [--groups 1 4] [--runs 5]

It prints each key's candidates (median and spread in ms), the SDPA-flash
time at the same shape, the prior's route and the winner, and writes
`DIR/tuning_<chip>.json` (`fa2_triton_tpu_torch/ops/tables` is the shipped
table; `$FA2_TUNING_DIR`, default `~/.cache/fa2_triton_tpu_torch`, is the
user's).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

ROUTE_KINDS = ("fwd_route", "bwd_route")
SWEEP_HEADS = 32
SWEEP_TOKENS = 4096
RUNS = 5


def _group(variant: str) -> int:
    """The GQA group of a `bwd_route` variant ('g4' -> 4; '' -> 1)."""
    return int(variant[1:]) if variant.startswith("g") else 1


def sweep_shape(seqlen: int, head_dim: int, variant: str = "") -> dict:
    """The shape a route key is swept at: its bucket's length minus one,
    enough rows for SWEEP_TOKENS tokens, bf16, causal."""
    from fa2_triton_tpu_torch.ops.autotune import _bucket

    bucket = _bucket(seqlen)
    return dict(B=max(1, SWEEP_TOKENS // bucket), Hq=SWEEP_HEADS,
                Hkv=SWEEP_HEADS // _group(variant), S=bucket - 1, D=head_dim)


def _gates(kind: str, shape: dict) -> dict:
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    kw = dict(causal=True, static_skip=True)
    if kind == "fwd_route":
        return flash_fwd.forward_gates(shape["S"], shape["S"], shape["D"], 2, **kw)
    return flash_bwd.backward_gates(shape["S"], shape["S"], shape["D"], 2,
                                    group=shape["Hq"] // shape["Hkv"], **kw)


def prior_route(kind: str, head_dim: int, seqlen: int, variant: str = "") -> str:
    """The route a call at the key's sweep shape takes without a table."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    sh = sweep_shape(seqlen, head_dim, variant)
    kw = dict(causal=True, static_skip=True)
    if kind == "fwd_route":
        return flash_fwd.forward_route(sh["S"], sh["S"], sh["D"], 2, **kw)
    return flash_bwd.backward_route(sh["S"], sh["S"], sh["D"], 2, group=sh["Hq"] // sh["Hkv"],
                                    **kw)


def candidates(kind: str, causal: bool, head_dim: int, seqlen: int,
               variant: str = "") -> Tuple[Tuple[str], ...]:
    """(route,) configs eligible at the key's sweep shape, in the prior's
    order; () for a tile kind (compile-time tiles) or a non-causal key."""
    if kind not in ROUTE_KINDS or not causal:
        return ()
    gates = _gates(kind, sweep_shape(seqlen, head_dim, variant))
    return tuple((route,) for route, ok in gates.items() if ok)


def _inputs(shape: dict, device, seed: int = 0):
    """q, k, v, do as BHSD views of BSHD memory (the public API's layout)
    and lens."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, Hq, Hkv, S, D = (shape[n] for n in ("B", "Hq", "Hkv", "S", "D"))
    q, k, v, do = (torch.randn(B, S, h, D, generator=g, device=device, dtype=torch.bfloat16)
                   .mul_(0.5).transpose(1, 2) for h in (Hq, Hkv, Hkv, Hq))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=device)
    return q, k, v, do, lens


def _calls(kind: str, shape: dict, routes, device):
    """{route: (fn, args)}: fn(*args) calls the port's launcher with the
    route forced. The tensors are passed as arguments, so `device_time`
    sees CUDA tensors and times by CUDA events."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    q, k, v, do, lens = _inputs(shape, device)
    kw = dict(causal=True, softmax_scale=shape["D"] ** -0.5, static_skip=True)
    if kind == "fwd_route":
        return {r: (lambda *x, r=r: flash_fwd.flash_attn_forward(*x, route=r, **kw),
                    (q, k, v, lens)) for r in routes}
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, route="generic", **kw)
    return {r: (lambda *x, r=r: flash_bwd.flash_attn_backward(*x, route=r, **kw),
                (q, k, v, do, o, lse, lens)) for r in routes}


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the micro-sweep times CUDA kernels; got device {device}")
    return device


def time_candidates(kind: str, causal: bool, head_dim: int, seqlen: int, variant: str = "",
                    runs: int = RUNS, device="cuda") -> Dict[str, List[float]]:
    """{route: `runs` device times in seconds} of the key's candidates at
    its sweep shape, the candidates taken in turns (each run in a rotated
    order). A candidate that fails to launch or runs out of memory is
    printed and left out."""
    from fa2_triton_tpu_torch.utils.benchmarking import device_time

    device = _check_device(device)
    routes = [c[0] for c in candidates(kind, causal, head_dim, seqlen, variant)]
    calls = _calls(kind, sweep_shape(seqlen, head_dim, variant), routes, device)
    times: Dict[str, List[float]] = {r: [] for r in routes}
    for i in range(runs):
        order = routes[i % len(routes):] + routes[:i % len(routes)] if routes else []
        for r in order:
            if r not in times:
                continue
            try:
                times[r].append(device_time(calls[r][0], *calls[r][1], iters=3))
            except (RuntimeError, ValueError) as e:  # launch failures and out of memory
                print(f"fa2 micro-sweep: {kind}{'+' + variant if variant else ''} D={head_dim} "
                      f"S={seqlen} {r} failed: {str(e)[:120]}", file=sys.stderr)
                del times[r]
                torch.cuda.empty_cache()
    return times


def spread(ts: List[float]) -> float:
    return max(ts) - min(ts)


def median(ts: List[float]) -> float:
    s = sorted(ts)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def decide(times: Dict[str, List[float]], prior: str) -> Optional[str]:
    """The winner: the fastest median where it beats the prior route's
    median by more than the larger max - min spread of the two, else the
    prior (None when nothing ran; the fastest when the prior did not)."""
    if not times:
        return None
    best = min(times, key=lambda r: median(times[r]))
    if prior not in times or best == prior:
        return best
    margin = median(times[prior]) - median(times[best])
    return best if margin > max(spread(times[best]), spread(times[prior])) else prior


def measure_config(kind: str, causal: bool, head_dim: int, seqlen: int, config: Tuple[str],
                   variant: str = "", runs: int = 1, device="cuda") -> float:
    """Median seconds of one call of the key's sweep shape with route
    config[0] forced; raises on a CPU device and where the launch fails."""
    from fa2_triton_tpu_torch.utils.benchmarking import device_time

    device = _check_device(device)
    if kind not in ROUTE_KINDS:
        raise ValueError(f"no micro-sweep recipe for kind {kind!r} on the card (its tiles are "
                         f"compile-time)")
    fn, args = _calls(kind, sweep_shape(seqlen, head_dim, variant), [config[0]], device)[config[0]]
    return median([device_time(fn, *args, iters=3) for _ in range(runs)])


def run_micro_sweep(kind: str, causal: bool, head_dim: int, seqlen: int, variant: str = "",
                    runs: int = RUNS) -> Optional[Tuple[str]]:
    """Sweep `candidates` on the current card; the winner by `decide`, as a
    (route,) config, or None (a tile kind, or nothing launched)."""
    if not candidates(kind, causal, head_dim, seqlen, variant):
        return None
    times = time_candidates(kind, causal, head_dim, seqlen, variant, runs=runs)
    for r, ts in times.items():
        print(f"fa2 tune-on-miss: {kind} D={head_dim} S={seqlen} {r}: "
              f"{median(ts) * 1e3:.3f} ms (spread {spread(ts) * 1e3:.3f})", file=sys.stderr)
    best = decide(times, prior_route(kind, head_dim, seqlen, variant))
    return (best,) if best is not None else None


def sdpa_flash_ms(kind: str, head_dim: int, seqlen: int, variant: str = "", runs: int = RUNS,
                  device="cuda") -> List[float]:
    """Device times (ms) of `scaled_dot_product_attention`'s flash backend
    at the key's sweep shape (GQA heads repeated outside it): its forward
    for `fwd_route`, its backward for `bwd_route`."""
    from fa2_triton_tpu_torch.other_implementations import sdpa_flash_attention
    from fa2_triton_tpu_torch.utils.benchmarking import device_time

    device = _check_device(device)
    q, k, v, do, _ = _inputs(sweep_shape(seqlen, head_dim, variant), device)
    q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    if kind == "fwd_route":
        def call(q, k, v):
            with torch.no_grad():
                return sdpa_flash_attention(q, k, v, causal=True)
    else:
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = sdpa_flash_attention(q, k, v, causal=True)

        def call(q, k, v):
            return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    return [device_time(call, q, k, v, iters=3) * 1e3 for _ in range(runs)]


def peak_bytes(kind: str, head_dim: int, seqlen: int, route: str, variant: str = "",
               device="cuda") -> int:
    """Peak device memory of one call with `route` forced (inputs included)."""
    device = _check_device(device)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    fn, args = _calls(kind, sweep_shape(seqlen, head_dim, variant), [route], device)[route]
    fn(*args)
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def sweep_key(kind: str, head_dim: int, bucket: int, variant: str = "", runs: int = RUNS) -> dict:
    """One key's measurements: each candidate's times, SDPA-flash's, the
    prior's route, the winner, and peak memory of the candidates tied with
    the winner (reported, never used to pick)."""
    times = time_candidates(kind, True, head_dim, bucket, variant, runs=runs)
    prior = prior_route(kind, head_dim, bucket, variant)
    winner = decide(times, prior)
    ties = [r for r in times if r != winner and winner is not None and abs(
        median(times[r]) - median(times[winner])) <= max(spread(times[r]), spread(times[winner]))]
    peaks = {r: peak_bytes(kind, head_dim, bucket, r, variant) for r in ties + [winner]} \
        if ties else {}
    return {"kind": kind, "variant": variant, "head_dim": head_dim, "bucket": bucket,
            "shape": sweep_shape(bucket, head_dim, variant), "prior": prior, "winner": winner,
            "ms": {r: [t * 1e3 for t in ts] for r, ts in times.items()},
            "sdpa_flash_ms": sdpa_flash_ms(kind, head_dim, bucket, variant, runs=runs),
            "peak_bytes": peaks}


def _fmt(ts: List[float]) -> str:
    return f"{median(ts):.4f} ms (spread {spread(ts):.4f})"


def main(argv=None) -> int:
    from fa2_triton_tpu_torch.ops.autotune import _key, detect_chip

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for tuning_<chip>.json")
    ap.add_argument("--report", help="JSON file for every measurement")
    ap.add_argument("--kinds", nargs="+", default=list(ROUTE_KINDS), choices=ROUTE_KINDS)
    ap.add_argument("--head-dims", nargs="+", type=int, default=[64, 128, 256])
    ap.add_argument("--buckets", nargs="+", type=int,
                    default=[512, 1024, 2048, 4096, 8192, 16384])
    ap.add_argument("--groups", nargs="+", type=int, default=[1, 4])
    ap.add_argument("--runs", type=int, default=RUNS)
    args = ap.parse_args(argv)
    if args.runs < 5:
        ap.error("--runs must be at least 5")
    if not torch.cuda.is_available():
        print("fa2 micro-sweep: no CUDA device", file=sys.stderr)
        return 2
    chip = detect_chip()
    table, rows = {}, []
    for kind in args.kinds:
        for variant in ([f"g{g}" for g in args.groups] if kind == "bwd_route" else [""]):
            for D in args.head_dims:
                for bucket in args.buckets:
                    row = sweep_key(kind, D, bucket, variant, runs=args.runs)
                    rows.append(row)
                    if row["winner"] is not None:
                        table[_key(kind, True, D, bucket, variant)] = [row["winner"]]
                    cands = ", ".join(f"{r} {_fmt(ts)}" for r, ts in row["ms"].items())
                    print(f"[sweep] {kind}{'+' + variant if variant else ''} D {D} bucket "
                          f"{bucket} {row['shape']}: {cands}; sdpa_flash "
                          f"{_fmt(row['sdpa_flash_ms'])}; prior {row['prior']}, winner "
                          f"{row['winner']}" + (f"; peak bytes {row['peak_bytes']}"
                                                if row["peak_bytes"] else ""), flush=True)
    out = Path(args.out) / f"tuning_{chip}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    print(f"[sweep] wrote {len(table)} entries to {out}")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"chip": chip, "device": torch.cuda.get_device_name(0), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
