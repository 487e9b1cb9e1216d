"""Checkpoint / resume for training state (PyTorch port of
`fa2_triton_tpu.utils.checkpoint`, which wraps orbax).

A step-numbered layout: `<directory>/<step>.pt`, one `torch.save` file per
step. `save(step, state)` copies the state to the host and writes it;
`restore(like_state)` reads the newest step with
`torch.load(weights_only=True)`; only the newest `max_to_keep` steps are
kept.

A save is atomic, as orbax's is: the file is written under a temporary
name, flushed to disk and renamed, so a crash during a save leaves the
newest complete step readable and never a truncated `<step>.pt`. Temporary
files a crash left behind are removed when a manager opens the directory.
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, List, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")
_TMP_SUFFIX = ".tmp"


def _to_host(tree: Any) -> Any:
    """A copy of `tree` whose tensors live in host memory, so the caller may
    go on updating its own tensors in place."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _place(like: Any, loaded: Any, where: str) -> Any:
    """`loaded` with each tensor that `like` names cast to that tensor's
    dtype and device (the shapes must match). What `like` does not name
    stays as loaded: on the CPU, memory-mapped, read only if used."""
    if isinstance(like, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or loaded.shape != like.shape:
            got = tuple(loaded.shape) if isinstance(loaded, torch.Tensor) else type(loaded).__name__
            raise ValueError(f"checkpoint entry {where}: {got}, expected {tuple(like.shape)}")
        return loaded.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"checkpoint entry {where}: expected a dict")
        missing = [k for k in like if k not in loaded]
        if missing:
            raise KeyError(f"checkpoint entry {where} lacks {missing}")
        return {k: _place(like[k], v, f"{where}[{k!r}]") if k in like else v
                for k, v in loaded.items()}
    if isinstance(like, (list, tuple)) and like:
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(like):
            raise ValueError(f"checkpoint entry {where}: expected {len(like)} items")
        return type(loaded)(_place(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(like, loaded)))
    return loaded


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if name.endswith(_TMP_SUFFIX) and _STEP_FILE.match(name[:-len(_TMP_SUFFIX)]):
                os.remove(os.path.join(self.directory, name))
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # Seconds of each write to disk (serialize, fsync, rename, prune),
        # in the background or not.
        self.write_s: List[float] = []

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _steps_on_disk(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def all_steps(self) -> List[int]:
        self.wait_until_finished()
        return self._steps_on_disk()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, wait: bool = True):
        """Copy `state` (nested dicts / lists of tensors and plain values)
        to the host, then write it as step `step`. With `wait=False` the
        write runs on a background thread; the copy is done before this
        returns, so the caller may update its tensors at once."""
        self.wait_until_finished()
        host = _to_host(state)
        if wait:
            self._write(step, host)
        else:
            self._writer = threading.Thread(target=self._write_async, args=(step, host),
                                            name=f"checkpoint-{step}", daemon=False)
            self._writer.start()

    def _write_async(self, step: int, host: Any):
        try:
            self._write(step, host)
        except Exception as e:  # re-raised by wait_until_finished
            self._error = e

    def _write(self, step: int, host: Any):
        t0 = time.perf_counter()
        final = self.path(step)
        tmp = final + _TMP_SUFFIX
        try:
            with open(tmp, "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if self.max_to_keep > 0:
            for old in self._steps_on_disk()[:-self.max_to_keep]:
                os.remove(self.path(old))
        self.write_s.append(time.perf_counter() - t0)

    def wait_until_finished(self):
        """Block until a background write has ended; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a background checkpoint write failed") from err

    def restore(self, like_state: Any, step: Optional[int] = None) -> Any:
        """Read step `step` (the newest when None) into the structure of
        `like_state` (e.g. a freshly initialized state): each tensor it
        names comes back with its dtype on its device; entries it does not
        name (an optimizer's lazily built state) stay on the CPU,
        memory-mapped, for the caller's `load_state_dict` to place."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        loaded = torch.load(self.path(step), map_location="cpu", weights_only=True, mmap=True)
        return _place(like_state, loaded, "state")

    def close(self):
        self.wait_until_finished()
