"""Serving throughput demo: continuous-batched greedy decode on the GPU
(counterpart of `fa2_triton_tpu.runtime.serving_demo`).

Measures end-to-end engine tokens/s on a LLaMA-style model with random
weights (seed 0); the last line of stdout is one JSON object, as in the
JAX demo.

Usage:
  python -m fa2_triton_tpu_torch.runtime.serving_demo                # bf16 KV
  python -m fa2_triton_tpu_torch.runtime.serving_demo --qdtype int8  # int8 KV
  python -m fa2_triton_tpu_torch.runtime.serving_demo --dim 1024 --layers 8
  python -m fa2_triton_tpu_torch.runtime.serving_demo --paged --prefix-cache \\
      --shared-prefix 512
  python -m fa2_triton_tpu_torch.runtime.serving_demo --tp 2          # 2 TP ranks

One device: the first CUDA device (bf16 weights), or the CPU with
`--device cpu` (fp32, the kernels' plain twins; tiny sizes only). `--tp N`
(JAX l.42, l.65-71) spawns N ranks that serve one tensor-parallel Engine
(`Engine(mesh=make_mesh(model=N))`): over NCCL, one GPU a rank, when the
machine has N GPUs; else over gloo, the ranks sharing the GPU (or the CPU)
and every collective staged through host memory (`parallel/collectives.py`).
Rank 0's result is printed.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from fa2_triton_tpu_torch.models import LlamaConfig, init_params
from fa2_triton_tpu_torch.runtime.serving import Engine, EngineStats, _bucket

QDTYPES = {None: None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--qdtype", default=None, choices=[None, "int8", "fp8"])
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: ranks spawned, one Engine shard each")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (shared page pool)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching (implies --paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request a common prompt prefix of this "
                         "many tokens (prefix-cache workload)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (paged mode); only full pages are "
                         "prefix-shareable, so keep <= --shared-prefix")
    args = ap.parse_args(argv)
    if args.tp < 1:
        raise ValueError(f"--tp must be >= 1, got {args.tp}")
    return args


def tp_backend(args) -> str:
    """NCCL when every rank has a GPU of its own, else gloo."""
    if args.device == "cuda" and torch.cuda.device_count() >= args.tp:
        return "nccl"
    return "gloo"


def _tp_rank(rank: int, world: int, args):
    """One rank of `--tp`: the demo on an Engine sharded over a model axis
    of `world` ranks; rank 0 returns the result, the others None."""
    from fa2_triton_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if tp_backend(args) == "nccl":
        torch.cuda.set_device(rank)
    out = serve(args, make_mesh(model=world), quiet=rank != 0)
    return out if rank == 0 else None


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False; "
                           "pass --device cpu to run the plain path on the CPU")
    if args.tp > 1:
        from fa2_triton_tpu_torch.parallel.launch import spawn_ranks

        line, stats = spawn_ranks(_tp_rank, args.tp, (args,), backend=tp_backend(args),
                                  timeout_s=3600)[0]
    else:
        line, stats = serve(args)
    print(json.dumps(line))
    return {**line, "stats": stats}


def serve(args, mesh=None, quiet: bool = False):
    """Build the model and the Engine (sharded over `mesh`'s model axis),
    warm up, drain the requests; returns (the JSON line, the stats), the
    line None when `quiet`."""
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = LlamaConfig(
        vocab_size=32000, dim=args.dim, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads,
        hidden_dim=int(args.dim * 2.75) // 128 * 128,
        max_seq_len=args.max_seq,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
    )
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    eng = Engine(model, cfg, n_slots=args.slots, max_seq=args.max_seq,
                 qdtype=QDTYPES[args.qdtype],
                 paged=args.paged or args.prefix_cache,
                 prefix_cache=args.prefix_cache,
                 page_size=args.page_size or (128 if args.prefix_cache else None),
                 mesh=mesh)
    del model   # a TP rank keeps only its shard (eng.params)

    rng = np.random.RandomState(0)
    shared = rng.randint(0, cfg.vocab_size, size=args.shared_prefix).tolist()
    for _ in range(args.requests):
        plen = rng.randint(args.prompt_len // 2, args.prompt_len + 1)
        eng.submit(shared + rng.randint(0, cfg.vocab_size, size=plen).tolist(),
                   max_new_tokens=args.new_tokens)

    # Warm up on throwaway requests, one per prompt bucket (kernel build,
    # cuBLAS and allocator set-up), so the measured drain excludes them.
    pending = list(eng.queue)
    eng.queue = []
    seen = set()
    for r in pending:
        bucket = _bucket(len(r.prompt))
        if bucket not in seen:
            seen.add(bucket)
            eng.submit([1] * len(r.prompt), max_new_tokens=2)
    eng.run()
    eng.queue = pending
    eng.stats = EngineStats()

    stats = eng.run()
    if quiet:
        return None, stats
    print(
        f"prefill {stats.prefill_tokens} tok "
        f"(+{stats.prefix_cached_tokens} from prefix cache), "
        f"decode {stats.decode_tokens} tok "
        f"in {stats.wall_s:.2f}s over {stats.decode_steps} steps",
        file=sys.stderr,
    )
    line = {
        "metric": ("serving_decode_tokens_per_s" + (f"_{args.qdtype}" if args.qdtype else "")
                   + (f"_tp{args.tp}" if args.tp > 1 else "")),
        "value": round(stats.decode_tokens_per_s, 1),
        "unit": "tokens/s",
        "vs_baseline": 1.0,
        # Where it ran: a CPU run's rate is the host's, not a card's.
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return line, stats


if __name__ == "__main__":
    main()
