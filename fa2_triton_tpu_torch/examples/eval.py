"""Perplexity evaluation over a token corpus (counterpart of `examples/eval.py`).

Loads a checkpoint saved by `examples/train.py --ckpt-dir` (or evaluates a
fresh init), streams deterministic [batch, seq + 1] windows from the
memory-mapped corpus (`utils/data.py`) and reports token-level
cross-entropy and perplexity. The eval step is one forward per batch under
`torch.inference_mode()` (no gradients, so remat is irrelevant).

    python -m fa2_triton_tpu_torch.examples.eval --data corpus.bin \\
        --ckpt-dir ckpt --batches 50 --batch 8 --seq 2048 --dim 1024 --layers 8
    python -m fa2_triton_tpu_torch.examples.eval --config mistral-7b-v0.3 \\
        --layers 4 --data corpus.bin --ckpt-dir ckpt --batches 2 --batch 2 --seq 2048

The model's widths must be the trained ones: the trainer's small model
(`--dim`, `--layers`, `--heads`, `--kv-heads`, `--vocab`) or a preset
(`--config`, with `--layers` for a cut depth). One device: the first CUDA
device, or the CPU with `--device cpu` (the kernels' plain twins; tiny
sizes only).
"""
from __future__ import annotations

import argparse
import itertools
import math
from typing import Dict, Iterable, Tuple

import torch

from fa2_triton_tpu_torch.examples.train import PRESETS, model_loss, preset_config
from fa2_triton_tpu_torch.models import LlamaConfig, init_params
from fa2_triton_tpu_torch.utils.checkpoint import CheckpointManager
from fa2_triton_tpu_torch.utils.data import TokenLoader, open_corpus, prefetch_to_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--config", default=None, choices=sorted(PRESETS),
                    help="published widths (default: the trainer's small model)")
    ap.add_argument("--data", required=True, metavar="FILE")
    ap.add_argument("--ckpt-dir", default=None,
                    help="train.py checkpoint to evaluate (fresh init if omitted: "
                         "useful as a sanity upper bound)")
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dim", type=int, default=None, help="model width without --config (512)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the preset's, or 4 without --config)")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def build_config(args) -> LlamaConfig:
    dtype = torch.bfloat16 if torch.device(args.device).type == "cuda" else torch.float32
    if args.config is not None:
        if args.dim is not None:
            raise ValueError("--dim and --config exclude each other: the preset fixes the widths")
        over = {"max_seq_len": max(args.seq + 1, PRESETS[args.config]["max_seq_len"])}
        if args.layers is not None:
            over["n_layers"] = args.layers
        return preset_config(args.config, dtype, **over)
    dim = args.dim or 512
    return LlamaConfig(
        vocab_size=args.vocab, dim=dim, n_layers=args.layers or 4, n_heads=args.heads,
        n_kv_heads=args.kv_heads, hidden_dim=int(dim * 2.75) // 128 * 128,
        max_seq_len=args.seq + 1, dtype=dtype)


@torch.inference_mode()
def evaluate(model, cfg: LlamaConfig, loader: Iterable, batches: int) -> Tuple[float, int]:
    """Mean next-token cross-entropy (nats per token) of `model` over the
    first `batches` batches of `loader`, each batch's mean loss weighted
    alike, as the JAX script averages. Returns (mean, batches used)."""
    loss = model_loss(cfg)
    device = model.embed.device
    total, n = 0.0, 0
    for tokens in prefetch_to_device(itertools.islice(loader, batches), device=device):
        total += float(loss(model, tokens.long()))
        n += 1
    return total / max(n, 1), n


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False; "
                           "pass --device cpu to run the plain path on the CPU")
    cfg = build_config(args)
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    step = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        try:
            # Only the model is read: the optimizer's entries stay mapped
            # from the file, untouched.
            state = mgr.restore({"step": 0})
        finally:
            mgr.close()
        model.load_state_dict(state["model"])
        step = int(state["step"])
        print(f"evaluating checkpoint step {step}")
    loader = TokenLoader(open_corpus(args.data, cfg.vocab_size), args.batch, args.seq,
                         seed=args.seed)
    nll, n = evaluate(model, cfg, loader, args.batches)
    print(f"{n} batches ({n * args.batch * args.seq} tokens): "
          f"cross-entropy {nll:.4f} nats/token, "
          f"perplexity {math.exp(nll):.2f}")
    return {"nll": nll, "batches": n, "step": step, "config": cfg}


if __name__ == "__main__":
    main()
