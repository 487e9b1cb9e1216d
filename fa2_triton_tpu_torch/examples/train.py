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
    python -m fa2_triton_tpu_torch.examples.train --config mistral-7b-v0.3 \\
        --layers 4 --dp 2 --tp 2 --fsdp --steps 2 --batch 2 --seq 2048 --remat

Without `--dp` / `--tp`, one process on one device: the first CUDA device,
or the CPU with an explicit `--device cpu` (the kernels' plain twins; tiny
sizes only). There is no silent fallback: without a GPU the default device
raises.

With `--dp N` and `--tp M` (and `--fsdp`, in any combination, as the JAX
script takes them) the step runs on N x M ranks over a (data N, model M)
mesh (`parallel/fsdp.py`): Megatron TP over `model` (`param_pspecs`; with
`--moe`, `moe_param_pspecs` and expert parallelism, `models/moe.py:
make_ep_mlp`), the batch cut over `data` (each data rank takes its
`--batch / N` rows of the global batch a single rank would take), and with
`--fsdp` ZeRO-3 over `data` (`fsdp_param_pspecs`: parameters, gradients
and AdamW moments 1 / N a rank). Under torchrun the process joins its
world (`parallel/launch.py:init_rank(env=True)`); else it spawns the N x M
ranks itself (`spawn_ranks`). The backend is NCCL when there is a card a
rank, else gloo: CPU tensors with `--device cpu`, or CUDA tensors staged
through host memory for ranks that share a card (NCCL refuses two ranks on
one device). Rank 0 names both on its first line and prints the losses;
the loss is the global batch's, the guard's verdict and the clipping norm
the whole mesh's (`utils/resilience.py`), so every rank takes the same
steps. With `--ckpt-dir` each rank saves and restores its own shard, in
`DIR/data<d>-model<m>/`, and `DIR/mesh.json` names the mesh: a restore
under another mesh raises. Random
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
there is no stacked multi-step dispatch, so nothing recompiles. `--moe E` trains
the Mixtral-style MoE family (`models/moe.py`: E experts, top-2, capacity
factor 1.25) through `moe.loss_fn`, as the JAX script does (`init_params`
builds the MoE layers of an `MoEConfig`); so does the `mixtral-8x7b-v0.1`
preset.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from fa2_triton_tpu_torch.models import LlamaConfig, init_params, loss_fn, moe
from fa2_triton_tpu_torch.utils.data import TokenLoader, open_corpus, prefetch_to_device
from fa2_triton_tpu_torch.utils.profiling import roofline
from fa2_triton_tpu_torch.utils.resilience import ResilientTrainer, clip_grads_, devices_healthy

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

# Checkpoint period with --ckpt-dir, the JAX script's default.
SAVE_EVERY = 5


def preset_config(name: str, dtype=torch.bfloat16, **overrides) -> LlamaConfig:
    """The preset's config (an `MoEConfig` where it has experts)."""
    kw = {**PRESETS[name], "dtype": dtype, **overrides}
    return (moe.MoEConfig if "n_experts" in kw else LlamaConfig)(**kw)


def model_loss(cfg: LlamaConfig, par=None):
    """The loss a config trains on: `moe.loss_fn` (with the router's aux
    loss) for an MoE config, else `loss_fn`. Over a mesh (`par`) an MoE
    model's experts run expert-parallel on its `model` axis
    (`moe.make_ep_mlp`), and over its `data` axis the routing's capacity,
    slots and aux loss are the whole batch's (`data_group`), as one rank's."""
    if not isinstance(cfg, moe.MoEConfig):
        return loss_fn
    if par is None:
        return moe.loss_fn
    mlp = moe.make_ep_mlp(par.mesh) if par.tp > 1 else moe.moe_mlp
    return functools.partial(moe.loss_fn, mlp_fn=mlp, data_group=par.data_group)


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


def optimizer_step(model, opt: torch.optim.Optimizer, lr: float, grad_clip: float,
                   par=None) -> None:
    """Global-norm clip of the gradients (0 = off), then one AdamW step at
    `lr`; the gradients are dropped afterwards. On a rank of a mesh (`par`,
    a `parallel/fsdp.py:FSDP`) the norm is the whole sharded gradient's."""
    if grad_clip > 0 and par is None:
        torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
    elif grad_clip > 0:
        grads = [p.grad for p in par.params]
        clip_grads_(grads, grad_clip, par.grad_norm(grads))
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)


def step_fns(cfg: LlamaConfig, lr_fn: Callable[[int], float], grad_clip: float,
             loss: Optional[Callable] = None, par=None) -> Tuple[Callable, Callable]:
    """`(grad_fn, apply_fn)` of one training step on a state `{"model",
    "opt", "step"}`, for `utils/resilience.py`'s guarded step: `grad_fn`
    returns the loss (`loss`, by default `model_loss(cfg)`) and the
    gradients of the trainable parameters without touching the state;
    `apply_fn` takes `optimizer_step` at `lr_fn(state["step"])`, the
    number of steps applied so far, and counts the step. On a rank of a
    mesh (`par`, a `parallel/fsdp.py:FSDP` whose `model` is the state's)
    the loss and gradients are `par.value_and_grad`'s."""
    loss = loss or model_loss(cfg, par)

    def params(model):
        return [p for p in model.parameters() if p.requires_grad]

    def grad_fn(state, tokens):
        if par is not None:
            return par.value_and_grad(loss, tokens.long())
        model = state["model"]
        value = loss(model, tokens.long())
        return value, torch.autograd.grad(value, params(model), allow_unused=True)

    def apply_fn(state, grads):
        model = state["model"]
        for p, g in zip(params(model), grads):
            p.grad = g
        optimizer_step(model, state["opt"], lr_fn(state["step"]), grad_clip, par)
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
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: the batch is cut over them")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (Megatron over heads, hidden and vocab)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard parameters, gradients and optimizer state over --dp")
    ap.add_argument("--data", default=None, metavar="FILE",
                    help="flat binary token corpus (utils/data.py); random tokens when omitted")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint here and resume from the newest checkpoint (off if omitted)")
    ap.add_argument("--save-every", type=int, default=None, metavar="STEPS",
                    help=f"checkpoint period with --ckpt-dir (default {SAVE_EVERY})")
    args = ap.parse_args(argv)
    if args.dp < 1 or args.tp < 1:
        raise ValueError(f"--dp and --tp must be at least 1, got {args.dp} and {args.tp}")
    if args.batch % args.dp:
        raise ValueError(f"--batch {args.batch} does not split over --dp {args.dp}")
    if args.save_every is not None and args.ckpt_dir is None:
        raise ValueError("--save-every needs --ckpt-dir")
    if args.save_every is None:
        args.save_every = SAVE_EVERY
    if args.save_every < 1:
        raise ValueError(f"--save-every must be at least 1, got {args.save_every}")
    return args


def build_config(args) -> LlamaConfig:
    """The config of the run; raises ValueError where `--tp` does not divide
    what it cuts (heads, and the hidden dim and vocab, or the experts)."""
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
        cfg = preset_config(args.config, dtype, **over)
    else:
        dim = args.dim or 512
        extra = dict(n_experts=args.moe) if args.moe else {}
        cfg = (moe.MoEConfig if args.moe else LlamaConfig)(
            vocab_size=32000, dim=dim, n_layers=args.layers or 4, n_heads=8, n_kv_heads=2,
            hidden_dim=int(dim * 2.75) // 128 * 128, max_seq_len=args.seq, dtype=dtype,
            remat=args.remat, **extra)
    cut = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads}
    if isinstance(cfg, moe.MoEConfig):
        cut["n_experts"] = cfg.n_experts
    else:
        cut.update(hidden_dim=cfg.hidden_dim, vocab_size=cfg.vocab_size)
    bad = {k: v for k, v in cut.items() if v % args.tp}
    if bad:
        raise ValueError(f"--tp {args.tp} does not divide {bad}")
    return cfg


def _devices_ok(device: torch.device) -> None:
    if device.type == "cuda":
        if not devices_healthy([device]):
            raise RuntimeError(f"device probe failed on {device}")
        torch.cuda.reset_peak_memory_stats(device)


def _device(args, rank: Optional[int] = None) -> torch.device:
    """The run's device: the CPU where asked for, else a card (on a rank
    of a mesh, its local rank's card, made current); raises without one."""
    if torch.device(args.device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False; "
                           "pass --device cpu to run the plain path on the CPU")
    if rank is None:
        return torch.device(args.device)
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                          % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _train(args, device: torch.device, on_warm, on_grads, mesh=None):
    """Build the model (on a rank of `mesh`, its `parallel/fsdp.py:FSDP`
    shard), resume from `--ckpt-dir`'s newest checkpoint (a rank's own
    directory), warm up (no state change), then take the guarded steps up to
    `args.steps` (a rank on its rows of each batch), checkpointing with
    `--ckpt-dir`. Returns (the result, the FSDP or None, the optimizer)."""
    cfg = build_config(args)
    _devices_ok(device)
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in model.parameters())
    par, ckpt, rows, group = None, args.ckpt_dir, slice(None), None
    if args.ckpt_dir is not None:     # another mesh's checkpoints raise here
        check_mesh_record(args.ckpt_dir, mesh_record(args), write=False)
    if mesh is not None:
        import torch.distributed as dist

        from fa2_triton_tpu_torch.parallel import collectives as coll
        from fa2_triton_tpu_torch.parallel.fsdp import FSDP, train_specs

        par = FSDP(model, mesh, train_specs(model, mesh, fsdp=args.fsdp,
                                            moe=isinstance(cfg, moe.MoEConfig)))
        model, group = par.model, dist.group.WORLD
        d, b = par.coords["data"], args.batch // args.dp
        rows = slice(d * b, (d + 1) * b)
        if args.ckpt_dir is not None:
            dist.barrier()
            if dist.get_rank() == 0:
                check_mesh_record(args.ckpt_dir, mesh_record(args), write=True)
            ckpt = os.path.join(args.ckpt_dir, f"data{d}-model{par.coords['model']}")
    state = {"model": model, "opt": make_optimizer(model, args.lr), "step": 0}
    grad_fn, apply_fn = step_fns(cfg, lambda step: lr_at(step, args.lr, args.steps, args.warmup),
                                 args.grad_clip, par=par)
    trainer = ResilientTrainer(grad_fn, apply_fn, ckpt, save_every=args.save_every, group=group)
    state, start = trainer.restore_or_init(state)
    batches = prefetch_to_device((b[rows] for b in host_batches(args, cfg.vocab_size, start)),
                                 size=2, device=device)
    if par is not None:
        coll.reset_staging()

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
            _, grads = grad_fn(state, first)
            if on_grads is not None:
                for p, g in zip((p for p in model.parameters() if p.requires_grad), grads):
                    p.grad = g
                on_grads(par if par is not None else model, first.long())
            del grads
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
        "config": cfg, "losses": losses, "step_s": step_s, "n_params": n_params,
        "tokens_per_step": tokens_per_step, "tokens_per_s": tokens_per_step / med,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "start": start, "report": trainer.report,
    }, par, state["opt"]


def run(args, on_warm: Optional[Callable[[], None]] = None,
        on_grads: Optional[Callable[[torch.nn.Module, torch.Tensor], None]] = None) -> Dict:
    """Build, resume from `--ckpt-dir`'s newest checkpoint if there is one,
    warm up (no state change), then take the guarded steps up to
    `args.steps`, checkpointing with `--ckpt-dir`. `on_grads(model,
    tokens)` is called after the warm-up's backward on the first batch,
    with the gradients in `model`'s `.grad` (they are the first step's,
    before clipping), and `on_warm` between the warm-up and the first step.
    Returns losses, per-step seconds, tokens/s, peak device memory, the
    config, the step it started from and the trainer's report (skips, save
    and restore seconds). With `--dp` / `--tp` above 1 the run is
    `run_parallel`'s (the hooks then run on every rank: they must pickle,
    and `on_grads` gets the rank's `parallel/fsdp.py:FSDP`)."""
    if args.dp * args.tp > 1:
        return run_parallel(args, on_warm, on_grads)
    return _train(args, _device(args), on_warm, on_grads)[0]


MESH_FILE = "mesh.json"


def mesh_record(args) -> Dict:
    """The layout a checkpoint holds: the mesh's sizes and FSDP on or off."""
    return {"data": args.dp, "model": args.tp, "fsdp": bool(args.fsdp and args.dp > 1)}


def check_mesh_record(ckpt_dir: str, want: Dict, write: bool) -> None:
    """Raise ValueError where `ckpt_dir` holds checkpoints of another mesh
    (`DIR/mesh.json`, which a mesh's run writes; step files in DIR itself
    are a single rank's, which writes no record); with `write`, record
    `want` where nothing is recorded yet."""
    path = os.path.join(ckpt_dir, MESH_FILE)
    if os.path.exists(path):
        with open(path) as f:
            got = json.load(f)
    elif os.path.isdir(ckpt_dir) and any(n.endswith(".pt") for n in os.listdir(ckpt_dir)):
        got = mesh_record(argparse.Namespace(dp=1, tp=1, fsdp=False))
    else:
        got = None
    if got is not None and got != want:
        raise ValueError(f"--ckpt-dir {ckpt_dir} holds a checkpoint of mesh {got}; this run's mesh "
                         f"is {want}: restore it under the mesh it was saved with")
    if got is None and write:
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump(want, f)
        os.replace(path + ".tmp", path)


def backend_for(args) -> Tuple[str, str]:
    """(backend, transport) of a mesh run: NCCL with a card a rank, else
    gloo (CPU tensors with --device cpu; CUDA tensors staged through host
    memory for ranks that share a card)."""
    world = args.dp * args.tp
    if torch.device(args.device).type == "cpu":
        return "gloo", "gloo, CPU tensors"
    n = torch.cuda.device_count()
    if n >= world:
        return "nccl", f"nccl, one card a rank ({world} of {n})"
    return "gloo", (f"gloo, CUDA tensors staged through host memory ({world} ranks on {n} "
                    f"card{'s' if n != 1 else ''}; NCCL refuses two ranks on one device)")


def _under_torchrun() -> bool:
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ)


def run_parallel(args, on_warm=None, on_grads=None) -> Dict:
    """`run` over a (data --dp, model --tp) mesh: joined under torchrun, else
    on ranks spawned here (a failed rank fails the run). Returns rank 0's
    result, with every rank's summary under "ranks"."""
    world = args.dp * args.tp
    backend, _ = backend_for(args)
    if args.ckpt_dir is not None:     # fail before any rank starts
        check_mesh_record(args.ckpt_dir, mesh_record(args), write=False)
    if _under_torchrun():
        import torch.distributed as dist

        from fa2_triton_tpu_torch.parallel.launch import init_rank

        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} ranks, --dp x --tp is "
                             f"{world}")
        init_rank(backend=backend, env=True)
        try:
            out = run_rank(args, on_warm, on_grads)
            ranks = [None] * world
            dist.all_gather_object(ranks, out["rank"])
        finally:
            dist.destroy_process_group()
        return {**out, "ranks": ranks}
    from fa2_triton_tpu_torch.parallel.launch import spawn_ranks

    outs = spawn_ranks(_spawned_rank, world, (args, on_warm, on_grads), backend=backend,
                       timeout_s=RANK_TIMEOUT_S)
    return {**outs[0], "ranks": [o["rank"] for o in outs]}


# A spawned world's deadline: a run of many steps takes long.
RANK_TIMEOUT_S = 24 * 3600.0


def _spawned_rank(rank: int, world: int, args, on_warm, on_grads) -> Dict:
    return run_rank(args, on_warm, on_grads)


def run_rank(args, on_warm=None, on_grads=None) -> Dict:
    """One rank's part of `run_parallel`, in a joined process group."""
    import torch.distributed as dist

    from fa2_triton_tpu_torch.parallel import collectives as coll
    from fa2_triton_tpu_torch.parallel.mesh import make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    backend, transport = backend_for(args)
    device = _device(args, rank)
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if rank == 0:
        print(f"[train] {world} ranks, mesh data {args.dp} x model {args.tp}"
              f"{' with FSDP' if args.fsdp and args.dp > 1 else ''}: backend {backend}, transport "
              f"{transport}", flush=True)
    res, par, opt = _train(args, device, on_warm, on_grads, make_mesh(data=args.dp, model=args.tp))
    staging = dict(coll.STAGING)
    res["rank"] = {
        "rank": rank, "coords": dict(par.coords), "param_bytes": par.param_bytes(),
        "moment_bytes": par.moment_bytes(opt), "step_s": res["step_s"],
        "peak_bytes": res["peak_bytes"], "staging": staging,
        "staging_ms_per_op": 1e3 * (staging["copy_s"] + staging["comm_s"]) / staging["ops"]
        if staging["ops"] else 0.0}
    res.update(backend=backend, transport=transport)
    return res


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
    for r in res.get("ranks", []):
        peak_r = f", peak {r['peak_bytes'] / 2**30:.2f} GiB" if r["peak_bytes"] is not None else ""
        print(f"[train] rank {r['rank']} {r['coords']}: parameters "
              f"{r['param_bytes'] / 1e9:.3f} GB, "
              f"AdamW moments {r['moment_bytes'] / 1e9:.3f} GB, step s "
              f"{[round(x, 3) for x in r['step_s']]}, host staging {r['staging']['ops']} ops, "
              f"{r['staging_ms_per_op']:.3f} ms an op{peak_r}")
    if "ranks" in res:
        where = f"{len(res['ranks'])} ranks ({res['transport']}) on {where}"
    print(f"{args.config or 'llama'}: {cfg.n_layers} layers, dim {cfg.dim}, "
          f"{res['n_params'] / 1e9:.3f} B params, {resumed}{len(res['losses'])} steps of "
          f"{args.batch} x {args.seq} on {where}: losses {[round(x, 4) for x in res['losses']]}, "
          f"skipped {report.steps_skipped}, median step {med:.3f} s, "
          f"{res['tokens_per_s']:.0f} tokens/s, peak memory {peak}; per-step {summary}")
    return res


if __name__ == "__main__":
    main()
