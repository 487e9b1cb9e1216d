"""Train a LLaMA-style model on the port's kernels (counterpart of `examples/train.py`).

    python -m fa2_triton_tpu_torch.examples.train --config mistral-7b-v0.3 \\
        --steps 4 --batch 2 --seq 2048 --remat
    python -m fa2_triton_tpu_torch.examples.train --config qwen1.5-7b \\
        --steps 3 --batch 1 --seq 8192 --remat

One process on one device: the first CUDA device, or the CPU with an
explicit `--device cpu` (the kernels' plain twins; tiny sizes only). There
is no silent fallback: without a GPU the default device raises. Random
weights come from a torch generator seeded 0, random tokens from
`np.random.RandomState(0)` as in the JAX script. The optimizer mirrors the
JAX script's `optax.chain(clip_by_global_norm, adamw(lr, weight_decay=0.01))`
with a constant LR or a linear warm-up then cosine decay to lr/10 over
`--steps`: `clip_grad_norm_` then `torch.optim.AdamW` (fused on the GPU, so
no full-size temporaries; moments in the parameters' dtype, as optax keeps
them).

Two faults of the JAX script (ROADMAP.md queue C) are not copied: the
warm-up is one forward and backward on the first batch whose gradients are
dropped, with no optimizer step, so it leaves the state as it was; and
there is no stacked multi-step dispatch, so nothing recompiles. The JAX
script's mesh, MoE, corpus and checkpoint options raise with a pointer to
ROADMAP.md.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fa2_triton_tpu_torch.models import LlamaConfig, init_params, loss_fn

# Published widths, from
# https://huggingface.co/mistralai/Mistral-7B-v0.3/blob/main/config.json:
# hidden 4096, 32 layers, 32 heads, 8 KV heads, head_dim 128, intermediate
# 14336, vocab 32768, rope_theta 1e6, rms_norm_eps 1e-5, untied lm_head,
# sliding_window null (full causal). 7.25 B parameters, 14.5 GB in bf16.
#
# Qwen1.5-7B, from https://huggingface.co/Qwen/Qwen1.5-7B/blob/main/config.json
# (the Qwen2 architecture): hidden 4096, 32 layers, 32 heads and 32 KV heads
# (MHA), head_dim 128, intermediate 11008, vocab 151936, rope_theta 1e6,
# rms_norm_eps 1e-6, max_position_embeddings 32768, untied lm_head,
# use_sliding_window false, and q/k/v projection biases. 7.72 B parameters,
# 15.4 GB in bf16. Its MHA takes the causal backward schedules of
# ops/flash_bwd.py: the tri-square at seq 2048, the work list at seq 8192.
PRESETS = {
    "mistral-7b-v0.3": dict(
        vocab_size=32768, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14336, head_dim=128, rope_theta=1e6, norm_eps=1e-5,
        max_seq_len=32768, sliding_window=-1),
    "qwen1.5-7b": dict(
        vocab_size=151936, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        hidden_dim=11008, head_dim=128, rope_theta=1e6, norm_eps=1e-6,
        max_seq_len=32768, sliding_window=-1, qkv_bias=True),
}

NOT_PORTED = {
    "dp": "data parallelism (ROADMAP.md queue A.7)",
    "tp": "tensor parallelism (ROADMAP.md queue A.7)",
    "fsdp": "FSDP / ZeRO-3 (ROADMAP.md queue A.7)",
    "moe": "MoE layers (ROADMAP.md queue A.5)",
    "data": "the token corpus loader utils/data.py (ROADMAP.md queue A.6)",
    "ckpt_dir": "checkpointing through ResilientTrainer (ROADMAP.md queue A.6)",
    "save_every": "checkpointing through ResilientTrainer (ROADMAP.md queue A.6)",
}
# Values of those flags that mean "off", as in the JAX script.
_OFF = {"dp": 1, "tp": 1, "moe": 0}


def preset_config(name: str, dtype=torch.bfloat16, **overrides) -> LlamaConfig:
    return LlamaConfig(**{**PRESETS[name], "dtype": dtype, **overrides})


def lr_at(step: int, peak: float, steps: int, warmup: int) -> float:
    """The JAX script's schedule: constant `peak` when `warmup` is 0, else
    optax.warmup_cosine_decay_schedule(0, peak, warmup, max(steps,
    warmup + 1), end_value=peak / 10) at optimizer step `step` (from 0)."""
    if not warmup:
        return peak
    if step < warmup:
        return peak * step / warmup
    decay = max(steps, warmup + 1) - warmup
    cos = 0.5 * (1.0 + math.cos(math.pi * min(step - warmup, decay) / decay))
    end = peak / 10
    return end + (peak - end) * cos


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=0.01) (b1 0.9, b2 0.999, eps 1e-8) on
    every parameter."""
    on_gpu = next(model.parameters()).is_cuda
    return torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.01,
                             fused=on_gpu, foreach=False if not on_gpu else None)


def optimizer_step(model, opt: torch.optim.Optimizer, lr: float, grad_clip: float) -> None:
    """Global-norm clip of the gradients (0 = off), then one AdamW step at
    `lr`; the gradients are dropped afterwards."""
    if grad_clip > 0:
        torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)


def train_step(model, opt: torch.optim.Optimizer, tokens: torch.Tensor, lr: float,
               grad_clip: float) -> torch.Tensor:
    """One step: loss, backward, `optimizer_step`. Returns the loss
    (detached, on the device)."""
    loss = loss_fn(model, tokens)
    loss.backward()
    optimizer_step(model, opt, lr, grad_clip)
    return loss.detach()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None, choices=sorted(PRESETS),
                    help="published widths (default: the JAX script's small model)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dim", type=int, default=None, help="model width without --config (512)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the preset's, or 4 without --config)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=0, metavar="STEPS",
                    help="linear warmup then cosine decay to lr/10 over --steps (0 = constant lr)")
    ap.add_argument("--grad-clip", type=float, default=1.0, metavar="NORM",
                    help="global-norm gradient clipping (0 = off)")
    ap.add_argument("--remat", action="store_true", help="per-layer gradient checkpointing")
    ap.add_argument("--repeat-batch", action="store_true",
                    help="train on the first batch every step (the loss must fall)")
    for flag in ("--dp", "--tp", "--moe"):
        ap.add_argument(flag, type=int, default=None, help="not ported: raises")
    ap.add_argument("--fsdp", action="store_true", default=None, help="not ported: raises")
    ap.add_argument("--data", default=None, help="not ported: raises")
    ap.add_argument("--ckpt-dir", default=None, help="not ported: raises")
    ap.add_argument("--save-every", type=int, default=None, help="not ported: raises")
    args = ap.parse_args(argv)
    for key, what in NOT_PORTED.items():
        val = getattr(args, key)
        if val is not None and val != _OFF.get(key):
            raise NotImplementedError(f"--{key.replace('_', '-')}: {what} is not ported yet")
    return args


def build_config(args) -> LlamaConfig:
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.config is not None:
        if args.dim is not None:
            raise ValueError("--dim and --config exclude each other: the preset fixes the widths")
        over = {"remat": args.remat, "max_seq_len": max(args.seq, PRESETS[args.config]["max_seq_len"])}
        if args.layers is not None:
            over["n_layers"] = args.layers
        return preset_config(args.config, dtype, **over)
    dim = args.dim or 512
    return LlamaConfig(vocab_size=32000, dim=dim, n_layers=args.layers or 4, n_heads=8,
                       n_kv_heads=2, hidden_dim=int(dim * 2.75) // 128 * 128,
                       max_seq_len=args.seq, dtype=dtype, remat=args.remat)


def run(args, on_warm: Optional[Callable[[], None]] = None) -> Dict:
    """Build, warm up (no state change), then take `args.steps` timed steps.
    `on_warm` is called between the warm-up and the first step. Returns
    losses, per-step seconds, tokens/s, peak device memory and the config."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False; "
                           "pass --device cpu to run the plain path on the CPU")
    cfg = build_config(args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in model.parameters())
    opt = make_optimizer(model, args.lr)
    rng = np.random.RandomState(0)

    def batch() -> torch.Tensor:
        return torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(args.batch, args.seq))).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    first = batch()
    # Warm-up: kernel build, cuBLAS and allocator set-up. Gradients are
    # dropped and the optimizer does not step, so the state is untouched.
    loss_fn(model, first).backward()
    model.zero_grad(set_to_none=True)
    sync()
    if on_warm is not None:
        on_warm()
    losses: List[float] = []
    step_s: List[float] = []
    for step in range(args.steps):
        tokens = first if (args.repeat_batch or step == 0) else batch()
        t0 = time.perf_counter()
        loss = train_step(model, opt, tokens, lr_at(step, args.lr, args.steps, args.warmup),
                          args.grad_clip)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    tokens_per_step = args.batch * (args.seq - 1)
    med = float(np.median(step_s)) if step_s else float("nan")
    return {
        "config": cfg, "n_params": n_params, "losses": losses, "step_s": step_s,
        "tokens_per_step": tokens_per_step, "tokens_per_s": tokens_per_step / med,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }


def main(argv=None) -> Dict:
    args = parse_args(argv)
    res = run(args)
    cfg = res["config"]
    where = torch.cuda.get_device_name(args.device) if args.device.startswith("cuda") else "cpu"
    peak = f"{res['peak_bytes'] / 2**30:.2f} GiB" if res["peak_bytes"] is not None else "n/a"
    print(f"{args.config or 'llama'}: {cfg.n_layers} layers, dim {cfg.dim}, "
          f"{res['n_params'] / 1e9:.3f} B params, {args.steps} steps of {args.batch} x {args.seq} "
          f"on {where}: losses {[round(x, 4) for x in res['losses']]}, "
          f"median step {np.median(res['step_s']):.3f} s, {res['tokens_per_s']:.0f} tokens/s, "
          f"peak memory {peak}")
    return res


if __name__ == "__main__":
    main()
