"""Failure detection and crash-resumable training (PyTorch port of
`fa2_triton_tpu.utils.resilience`).

* **step-level failure detection**: non-finite loss / gradient detection on
  the device (one fused all-finite reduction per dtype) with
  skip-and-continue semantics: a bad step contributes no update;
* **device health check**: a probe that every CUDA device still answers,
  in a subprocess bounded by a timeout;
* **auto-resume**: `ResilientTrainer` checkpoints periodically
  (`utils/checkpoint.py`) and restores the newest state on restart, so a
  crash costs at most `save_every` steps;
* **over a mesh**: with a process `group` the verdict is the group's (a
  count of not-finite ranks, summed), so every rank skips the same steps
  and none waits in a collective that a skipping peer never joins; and
  `global_grad_norm` / `clip_grads_` clip by the norm of the whole sharded
  gradient, not a shard's.

Torch state is mutable, and that changes the design. JAX computes the new
state and selects the old or the new one with `jnp.where`; its async save
snapshots arrays that the next step replaces but never overwrites. The
port's AdamW updates in place, so keeping the old state to roll back to
would cost a second copy of it (43.5 GB at Mistral-7B depth), and a save
running beside the next step would read tensors that step overwrites.
Instead:

- A step is two functions: `grad_fn(state, batch) -> (loss, grads)`
  computes the loss and its gradients without touching the state, and
  `apply_fn(state, grads)` updates the state in place. The guard checks
  the loss and the gradients, and calls `apply_fn` only when all are
  finite. A skipped step leaves the parameters, the optimizer's moments
  and its step count bit for bit as they were; its gradients are dropped.
- The guard reads its verdict on the host (one scalar): a trainer that
  reads its loss every step pays no extra synchronisation for it.
- `save(wait=False)` copies the state to the host before it returns; only
  the write to disk runs beside the next steps.

One case differs from JAX: finite gradients whose update overflows (a
parameter or moment becomes inf). JAX checks the new state and rolls such
a step back; the port checks before the update, so it keeps the step.

A state is a dict whose values are tensors, plain values, or objects with
`state_dict()` / `load_state_dict()` (a module, an optimizer). Its
checkpoint holds each object's `state_dict()` under its key.
"""
from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from fa2_triton_tpu_torch.utils.checkpoint import CheckpointManager


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _tensor_leaves(item)]
    return []


@torch.no_grad()
def tree_allfinite(tree: Any) -> torch.Tensor:
    """0-dim bool tensor: every floating-point tensor of the tree is finite.

    One multi-tensor launch per (device, dtype) group: the largest
    magnitude of each tensor (`torch._foreach_norm` at order inf, which
    `clip_grad_norm_` runs; a NaN propagates, and the max of finite values
    cannot overflow), then one check of those few scalars, instead of a
    reduction per tensor."""
    groups: Dict[Tuple[torch.device, torch.dtype], List[torch.Tensor]] = {}
    for x in _tensor_leaves(tree):
        if x.is_floating_point():
            groups.setdefault((x.device, x.dtype), []).append(x.detach())
    if not groups:
        return torch.tensor(True)
    flags = [torch.stack(torch._foreach_norm(xs, float("inf"))).isfinite().all()
             for xs in groups.values()]
    first = flags[0].device
    return torch.stack([f.to(first) for f in flags]).all()


def guarded_update(state: Any, grads: Any, ok: bool, apply_fn: Callable) -> bool:
    """Apply `apply_fn(state, grads)` where the step was healthy; else leave
    the state untouched. The counterpart of JAX's select: nothing was
    updated yet, so nothing needs rolling back."""
    if ok:
        apply_fn(state, grads)
    return ok


def make_guarded_step(grad_fn: Callable, apply_fn: Callable, group=None) -> Callable:
    """`guarded(state, batch) -> (state, loss, ok)`: the step, taken only
    when the loss and every gradient are finite; `state` is updated in
    place and returned, `loss` is detached, `ok` a Python bool. With a
    process `group` (every rank of a mesh) `ok` holds only where every
    rank's loss and gradients are finite: each rank's flag is summed over
    the group (`parallel/collectives.py:all_reduce`), so all skip together."""

    def guarded(state, batch):
        loss, grads = grad_fn(state, batch)
        loss = loss.detach()
        bad = (~tree_allfinite([loss, grads])).float().reshape(1)
        if group is not None:
            from fa2_triton_tpu_torch.parallel.collectives import all_reduce

            bad = all_reduce(bad.to(loss.device), group)
        ok = not bool(bad.item())
        guarded_update(state, grads, ok, apply_fn)
        return state, loss, ok

    return guarded


@torch.no_grad()
def global_grad_norm(grads, cut_by, groups) -> torch.Tensor:
    """The 2-norm of a whole gradient of which this rank holds pieces: the
    squares of each leaf's piece, summed with those of the leaves cut over
    the same axes (`cut_by[i]`: the names of the axes whose ranks hold
    different pieces of leaf i, () for a leaf every rank holds whole), each
    sum all-reduced over its axes' groups (`groups`: name -> group), and a
    whole leaf counted once. Every rank gets the same fp32 0-dim tensor.
    None gradients count as 0."""
    from fa2_triton_tpu_torch.parallel.collectives import all_reduce

    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    device = None
    for g, axes in zip(grads, cut_by):
        if g is None:
            continue
        device = device or g.device
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).double().square().to(device)
        key = tuple(sorted(axes))
        sums[key] = sums[key] + sq if key in sums else sq
    total = torch.zeros((), dtype=torch.float64, device=device)
    # Every rank holds the same leaves, so the same keys in the same order.
    for key in sorted(sums):
        part = sums[key]
        for axis in key:
            part = all_reduce(part, groups[axis])
        total = total + part
    return total.sqrt().float()


@torch.no_grad()
def clip_grads_(grads, max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    """Scale `grads` in place so their norm `norm` is at most `max_norm`
    (`torch.nn.utils.clip_grad_norm_`'s rule: by min(1, max_norm / (norm +
    1e-6))); returns `norm`."""
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        if g is not None:
            g.mul_(coef.to(g.device))
    return norm


def make_guarded_multi_step(grad_fn: Callable, apply_fn: Callable) -> Callable:
    """The guarded step over a [K, ...]-stacked batch (or any sequence of K
    batches), one step each. Returns `(state, losses[K], oks[K])`. JAX
    scans the K steps in one dispatch to amortize a TPU tunnel's latency;
    a CUDA launch costs microseconds, so the port loops."""
    guarded = make_guarded_step(grad_fn, apply_fn)

    def multi(state, batches):
        losses, oks = [], []
        for batch in batches:
            state, loss, ok = guarded(state, batch)
            losses.append(loss)
            oks.append(ok)
        return state, torch.stack(losses), torch.tensor(oks)

    return multi


_PROBE = (
    "import torch\n"
    "assert torch.cuda.is_available()\n"
    "for i in range(torch.cuda.device_count()):\n"
    "    x = torch.ones((8, 128), dtype=torch.float32, device=f'cuda:{i}')\n"
    "    assert float(x.sum()) == 8 * 128\n"
    "print('HEALTHY')\n"
)


def devices_healthy(devices=None, timeout_s: float = 30.0) -> bool:
    """Probe that every device runs a trivial kernel and returns its result.

    With `devices=None` the probe covers every CUDA device, in a
    SUBPROCESS bounded by `timeout_s`, so a wedged CUDA runtime surfaces as
    False instead of hanging the caller; without a CUDA device it is False.
    With explicit `devices` the probe runs inline on those devices (no
    timeout protection)."""
    if devices is not None:
        try:
            for d in devices:
                x = torch.ones((8, 128), dtype=torch.float32, device=d)
                if float(x.sum()) != 8 * 128:
                    return False
            return True
        except RuntimeError:
            return False
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False
    return "HEALTHY" in out.stdout


@dataclass
class TrainerReport:
    steps_run: int = 0
    steps_skipped: int = 0
    resumed_from: Optional[int] = None
    last_loss: float = float("nan")
    # Host seconds of each save call (the copy to the host, and the write
    # when the save waits for it), of each write to disk (in the background
    # or not) and of the restore (read and load_state_dict).
    save_s: List[float] = field(default_factory=list)
    write_s: List[float] = field(default_factory=list)
    restore_s: Optional[float] = None


def _stateful(v) -> bool:
    return hasattr(v, "state_dict") and hasattr(v, "load_state_dict")


def _checkpoint_form(state: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpointable form of a state: each object's `state_dict()`,
    tensors and plain values as they are."""
    return {k: v.state_dict() if _stateful(v) else v for k, v in state.items()}


@torch.no_grad()
def _load_state(state: Dict[str, Any], saved: Dict[str, Any]) -> None:
    """Load a checkpoint's entries into `state` in place."""
    for k, v in state.items():
        if _stateful(v):
            v.load_state_dict(saved[k])
        elif isinstance(v, torch.Tensor):
            v.copy_(saved[k])
        else:
            state[k] = saved[k]


class ResilientTrainer:
    """Checkpointed, failure-tolerant training loop.

    The guarded step (`make_guarded_step(grad_fn, apply_fn)`) skips
    non-finite steps; with a `ckpt_dir` the trainer saves every
    `save_every` steps and `restore_or_init` resumes from the newest
    checkpoint. Without one (`ckpt_dir=None`) it only guards. On a rank of a
    mesh, `group` (the world) makes the guard's verdict every rank's, and
    `ckpt_dir` is the rank's own directory (`examples/train.py`).
    """

    def __init__(self, grad_fn: Callable, apply_fn: Callable, ckpt_dir: Optional[str],
                 save_every: int = 100, max_to_keep: int = 3, group=None):
        self._guarded = make_guarded_step(grad_fn, apply_fn, group)
        self._ckpt = (CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)
                      if ckpt_dir is not None else None)
        self._save_every = save_every
        self._last_saved: Optional[int] = None
        self.report = TrainerReport(
            write_s=self._ckpt.write_s if self._ckpt is not None else [])

    def restore_or_init(self, init_state: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
        """Resume from the newest checkpoint (loaded into `init_state` in
        place), else return `init_state` as it is. Returns (state, step)."""
        latest = self._ckpt.latest_step() if self._ckpt is not None else None
        if latest is None:
            return init_state, 0
        t0 = time.perf_counter()
        # Tensors and values of the state are placed like it; each object's
        # entries stay memory-mapped until its load_state_dict copies them.
        like = {k: v for k, v in init_state.items() if not _stateful(v)}
        _load_state(init_state, self._ckpt.restore(like, step=latest))
        self.report.restore_s = time.perf_counter() - t0
        self.report.resumed_from = latest
        self._last_saved = latest
        return init_state, latest

    def save(self, step: int, state: Dict[str, Any], wait: bool = True):
        t0 = time.perf_counter()
        self._ckpt.save(step, _checkpoint_form(state), wait=wait)
        self.report.save_s.append(time.perf_counter() - t0)
        self._last_saved = step

    def step(self, state: Dict[str, Any], batch, step: int) -> Tuple[float, bool]:
        """One guarded step, taken as step `step` of the run (numbered from
        0); saves after it when it completes a `save_every` period.
        Returns (loss, ok)."""
        state, loss, ok = self._guarded(state, batch)
        self.report.steps_run += 1
        self.report.steps_skipped += int(not ok)
        self.report.last_loss = float(loss)
        done = step + 1
        if self._ckpt is not None and done // self._save_every > step // self._save_every:
            self.save(done, state, wait=False)
        return self.report.last_loss, ok

    def finish(self, state: Dict[str, Any], step: int):
        """Save step `step` unless the newest save is of that step, and wait
        until every write is on disk."""
        if self._ckpt is None:
            return
        if self._last_saved != step:
            self.save(step, state)
        self._ckpt.wait_until_finished()

    def run(self, state: Dict[str, Any], batches, start_step: int = 0,
            final_save: bool = True) -> Dict[str, Any]:
        """Guarded steps over `batches` from step `start_step`; with
        `final_save`, `finish` at the last step."""
        step = start_step
        for batch in batches:
            self.step(state, batch, step)
            step += 1
        if final_save:
            self.finish(state, step)
        return state

    def close(self):
        if self._ckpt is not None:
            self._ckpt.close()
