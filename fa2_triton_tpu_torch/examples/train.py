"""Train a LLaMA-style model on the port's kernels (counterpart of `examples/train.py`).

    python -m fa2_triton_tpu_torch.examples.train --config mistral-7b-v0.3 \\
        --steps 4 --batch 2 --seq 2048 --remat
    python -m fa2_triton_tpu_torch.examples.train --config mistral-7b-v0.3 \\
        --layers 4 --steps 6 --batch 2 --seq 2048 --remat \\
        --data corpus.bin --ckpt-dir ckpt --save-every 2
    python -m fa2_triton_tpu_torch.examples.train --config qwen1.5-7b \\
        --steps 3 --batch 1 --seq 8192 --remat
    python -m fa2_triton_tpu_torch.examples.train --config mixtral-8x7b-v0.1 \\
        --layers 5 --steps 3 --batch 2 --seq 2048 --remat

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

Every step is `utils/resilience.py`'s guarded step: a step whose loss or
any gradient is not finite is skipped, leaving the parameters, the AdamW
moments and the step count as they were, and counted. `--data FILE` trains
on a flat token corpus (`utils/data.py`: windows of `--seq - 1` tokens plus
their target, shuffled per epoch from seed 0), else on random tokens.
`--ckpt-dir DIR` saves the model, the optimizer and the step count every
`--save-every` steps (5 by default) and at the end, and resumes from the
newest checkpoint in DIR. `--steps` is the run's whole length (and the LR
schedule's), so a resumed run takes steps `start .. --steps - 1`: the LR
schedule continues at the restored step, random tokens come from
`RandomState(start)` as in the JAX script, and a corpus continues at the
window an uninterrupted run would take at that step (the JAX script starts
its corpus again at window 0: ROADMAP.md queue C). Checkpointing is off
unless `--ckpt-dir` is given, where the JAX script saves to
/tmp/fa2_train_ckpt every 5 steps by default: at Mistral-7B-v0.3's full
depth each save writes the bf16 weights and both AdamW moments, 43.5 GB.

Two faults of the JAX script (ROADMAP.md queue C) are not copied: the
warm-up is one forward and backward on the first batch whose gradients are
dropped, with no optimizer step, so it leaves the state as it was; and
there is no stacked multi-step dispatch, so nothing recompiles. The JAX
script's mesh options raise with a pointer to ROADMAP.md. `--moe E` trains
the Mixtral-style MoE family (`models/moe.py`: E experts, top-2, capacity
factor 1.25) through `moe.loss_fn`, as the JAX script does (`init_params`
builds the MoE layers of an `MoEConfig`); so does the `mixtral-8x7b-v0.1`
preset.
"""
from __future__ import annotations

import argparse
import itertools
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from fa2_triton_tpu_torch.models import LlamaConfig, init_params, loss_fn, moe
from fa2_triton_tpu_torch.utils.data import TokenLoader, open_corpus, prefetch_to_device
from fa2_triton_tpu_torch.utils.profiling import roofline
from fa2_triton_tpu_torch.utils.resilience import ResilientTrainer, devices_healthy

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
#
# Mixtral-8x7B-v0.1, from
# https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/main/config.json:
# vocab 32000, hidden 4096, 32 layers, 32 heads, 8 KV heads, head_dim 128,
# intermediate 14336, 8 local experts, 2 per token, rope_theta 1e6,
# rms_norm_eps 1e-5, max_position_embeddings 32768, no sliding window,
# untied lm_head, router_aux_loss_coef 0.02. 46.7 B parameters (each layer
# 1.451 B: experts 1.409 B, attention 0.042 B; embedding and head 0.262 B).
# Mixtral routes without dropping tokens; the port's training block keeps
# the JAX package's capacity factor 1.25 (models/moe.py).
PRESETS = {
    "mistral-7b-v0.3": dict(
        vocab_size=32768, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14336, head_dim=128, rope_theta=1e6, norm_eps=1e-5,
        max_seq_len=32768, sliding_window=-1),
    "qwen1.5-7b": dict(
        vocab_size=151936, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        hidden_dim=11008, head_dim=128, rope_theta=1e6, norm_eps=1e-6,
        max_seq_len=32768, sliding_window=-1, qkv_bias=True),
    "mixtral-8x7b-v0.1": dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14336, head_dim=128, rope_theta=1e6, norm_eps=1e-5,
        max_seq_len=32768, sliding_window=-1, n_experts=8, top_k=2,
        router_aux_coef=0.02),
}

NOT_PORTED = {
    "dp": "data parallelism (ROADMAP.md queue A.7(ii))",
    "tp": "tensor parallelism (ROADMAP.md queue A.7(ii))",
    "fsdp": "FSDP / ZeRO-3 (ROADMAP.md queue A.7(ii))",
}
# Values of those flags that mean "off", as in the JAX script.
_OFF = {"dp": 1, "tp": 1}
# Checkpoint period with --ckpt-dir, the JAX script's default.
SAVE_EVERY = 5


def preset_config(name: str, dtype=torch.bfloat16, **overrides) -> LlamaConfig:
    """The preset's config (an `MoEConfig` where it has experts)."""
    kw = {**PRESETS[name], "dtype": dtype, **overrides}
    return (moe.MoEConfig if "n_experts" in kw else LlamaConfig)(**kw)


def model_loss(cfg: LlamaConfig):
    """The loss a config trains on: `moe.loss_fn` (with the router's aux
    loss) for an MoE config, else `loss_fn`."""
    return moe.loss_fn if isinstance(cfg, moe.MoEConfig) else loss_fn


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


def step_fns(cfg: LlamaConfig, lr_fn: Callable[[int], float], grad_clip: float,
             loss: Optional[Callable] = None) -> Tuple[Callable, Callable]:
    """`(grad_fn, apply_fn)` of one training step on a state `{"model",
    "opt", "step"}`, for `utils/resilience.py`'s guarded step: `grad_fn`
    returns the loss (`loss`, by default `model_loss(cfg)`) and the
    gradients of the trainable parameters without touching the state;
    `apply_fn` takes `optimizer_step` at `lr_fn(state["step"])`, the
    number of steps applied so far, and counts the step."""
    loss = loss or model_loss(cfg)

    def params(model):
        return [p for p in model.parameters() if p.requires_grad]

    def grad_fn(state, tokens):
        model = state["model"]
        value = loss(model, tokens.long())
        return value, torch.autograd.grad(value, params(model), allow_unused=True)

    def apply_fn(state, grads):
        model = state["model"]
        for p, g in zip(params(model), grads):
            p.grad = g
        optimizer_step(model, state["opt"], lr_fn(state["step"]), grad_clip)
        state["step"] += 1

    return grad_fn, apply_fn


def host_batches(args, vocab_size: int, start: int) -> Iterator[np.ndarray]:
    """The [batch, seq] int32 token batches of steps `start .. --steps - 1`:
    the corpus's windows of seq - 1 tokens plus their target from the
    window an uninterrupted run takes at step `start`, or random tokens from
    `RandomState(start)`."""
    n = max(args.steps - start, 0)
    if args.data:
        loader = TokenLoader(open_corpus(args.data, vocab_size), args.batch, args.seq - 1, seed=0)
        return itertools.islice(loader.stream(start), n)
    rng = np.random.RandomState(start)
    return (rng.randint(0, vocab_size, size=(args.batch, args.seq)).astype(np.int32)
            for _ in range(n))


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
    ap.add_argument("--moe", type=int, default=0, metavar="E",
                    help="MoE layers of E experts, top-2 (0 = dense; overrides a preset's count)")
    for flag in ("--dp", "--tp"):
        ap.add_argument(flag, type=int, default=None, help="not ported: raises")
    ap.add_argument("--fsdp", action="store_true", default=None, help="not ported: raises")
    ap.add_argument("--data", default=None, metavar="FILE",
                    help="flat binary token corpus (utils/data.py); random tokens when omitted")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint here and resume from the newest checkpoint (off if omitted)")
    ap.add_argument("--save-every", type=int, default=None, metavar="STEPS",
                    help=f"checkpoint period with --ckpt-dir (default {SAVE_EVERY})")
    args = ap.parse_args(argv)
    for key, what in NOT_PORTED.items():
        val = getattr(args, key)
        if val is not None and val != _OFF.get(key):
            raise NotImplementedError(f"--{key.replace('_', '-')}: {what} is not ported yet")
    if args.save_every is not None and args.ckpt_dir is None:
        raise ValueError("--save-every needs --ckpt-dir")
    if args.save_every is None:
        args.save_every = SAVE_EVERY
    if args.save_every < 1:
        raise ValueError(f"--save-every must be at least 1, got {args.save_every}")
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
        if args.moe:
            over["n_experts"] = args.moe
        return preset_config(args.config, dtype, **over)
    dim = args.dim or 512
    extra = dict(n_experts=args.moe) if args.moe else {}
    return (moe.MoEConfig if args.moe else LlamaConfig)(
        vocab_size=32000, dim=dim, n_layers=args.layers or 4, n_heads=8, n_kv_heads=2,
        hidden_dim=int(dim * 2.75) // 128 * 128, max_seq_len=args.seq, dtype=dtype,
        remat=args.remat, **extra)


def run(args, on_warm: Optional[Callable[[], None]] = None,
        on_grads: Optional[Callable[[torch.nn.Module, torch.Tensor], None]] = None) -> Dict:
    """Build, resume from `--ckpt-dir`'s newest checkpoint if there is one,
    warm up (no state change), then take the guarded steps up to
    `args.steps`, checkpointing with `--ckpt-dir`. `on_grads(model,
    tokens)` is called after the warm-up's backward on the first batch,
    before its gradients are dropped (they are the first step's), and
    `on_warm` between the warm-up and the first step. Returns losses,
    per-step seconds, tokens/s, peak device memory, the config, the step
    it started from and the trainer's report (skips, save and restore
    seconds)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False; "
                           "pass --device cpu to run the plain path on the CPU")
    cfg = build_config(args)
    if device.type == "cuda":
        if not devices_healthy([device]):
            raise RuntimeError(f"device probe failed on {device}")
        torch.cuda.reset_peak_memory_stats(device)
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in model.parameters())
    state = {"model": model, "opt": make_optimizer(model, args.lr), "step": 0}
    trainer = ResilientTrainer(
        *step_fns(cfg, lambda step: lr_at(step, args.lr, args.steps, args.warmup), args.grad_clip),
        args.ckpt_dir, save_every=args.save_every)
    state, start = trainer.restore_or_init(state)
    batches = prefetch_to_device(host_batches(args, cfg.vocab_size, start), size=2, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses: List[float] = []
    step_s: List[float] = []
    try:
        first = next(batches, None)
        if first is not None:
            # Warm-up: kernel build, cuBLAS and allocator set-up. Gradients
            # are dropped and the optimizer does not step, so the state is
            # untouched.
            model_loss(cfg)(model, first.long()).backward()
            if on_grads is not None:
                on_grads(model, first.long())
            model.zero_grad(set_to_none=True)
            sync()
            if on_warm is not None:
                on_warm()
        for step in range(start, args.steps):
            tokens = first if (args.repeat_batch or step == start) else next(batches)
            t0 = time.perf_counter()
            loss, _ = trainer.step(state, tokens, step)
            sync()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
        if args.steps > start:
            trainer.finish(state, args.steps)
    finally:
        trainer.close()
    tokens_per_step = args.batch * (args.seq - 1)
    med = float(np.median(step_s)) if step_s else float("nan")
    return {
        "config": cfg, "n_params": n_params, "losses": losses, "step_s": step_s,
        "tokens_per_step": tokens_per_step, "tokens_per_s": tokens_per_step / med,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "start": start, "report": trainer.report,
    }


def main(argv=None) -> Dict:
    args = parse_args(argv)
    res = run(args)
    cfg, report = res["config"], res["report"]
    on_gpu = args.device.startswith("cuda")
    where = torch.cuda.get_device_name(args.device) if on_gpu else "cpu"
    peak = f"{res['peak_bytes'] / 2**30:.2f} GiB" if res["peak_bytes"] is not None else "n/a"
    med = np.median(res["step_s"]) if res["step_s"] else float("nan")
    # ~6 x params x tokens FLOPs for a decoder's forward and backward, and
    # the bf16 weights read twice, as the JAX script counts.
    summary = (roofline(time_s=med, flops=6 * res["n_params"] * res["tokens_per_step"],
                        bytes_moved=2 * res["n_params"] * 2).summary()
               if on_gpu and res["step_s"] else "no roofline (not measured on a GPU)")
    resumed = f"resumed from step {res['start']}, " if report.resumed_from is not None else ""
    print(f"{args.config or 'llama'}: {cfg.n_layers} layers, dim {cfg.dim}, "
          f"{res['n_params'] / 1e9:.3f} B params, {resumed}{len(res['losses'])} steps of "
          f"{args.batch} x {args.seq} on {where}: losses {[round(x, 4) for x in res['losses']]}, "
          f"skipped {report.steps_skipped}, median step {med:.3f} s, "
          f"{res['tokens_per_s']:.0f} tokens/s, peak memory {peak}; per-step {summary}")
    return res


if __name__ == "__main__":
    main()
