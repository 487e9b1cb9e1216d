"""Training data pipeline: memory-mapped token corpus -> device batches
(PyTorch port of `fa2_triton_tpu.utils.data`).

- **Zero-copy corpus**: tokens live in a flat binary file (`np.memmap`);
  nothing is loaded eagerly. `encode_corpus` writes the file, its dtype
  chosen from the vocab size; the bytes are those the JAX package writes.
- **Static-shape batches**: every batch is [batch, seq_len + 1] int32
  (inputs = [:, :-1], targets = [:, 1:], the `loss_fn` convention).
- **Deterministic shuffling**: window order is a seeded permutation per
  epoch, drawn as the JAX package draws it, so (seed, epoch, step) gives
  the same windows bit for bit in both packages; `TokenLoader.stream(step)`
  resumes the stream at a global step.
- **Device prefetch**: `prefetch_to_device` keeps N batches in flight; on
  the GPU each copy leaves pinned memory with `non_blocking=True`, so the
  H2D copy of batch i+1 overlaps the compute of batch i.
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from fa2_triton_tpu_torch.utils.common import resolve_device


def _corpus_dtype(vocab_size: int):
    return np.uint16 if vocab_size <= np.iinfo(np.uint16).max + 1 else np.uint32


def encode_corpus(tokens, path: str, vocab_size: int) -> np.memmap:
    """Write a token sequence to a flat binary file (dtype sized to vocab)."""
    dtype = _corpus_dtype(vocab_size)
    arr = np.asarray(tokens, dtype=dtype)
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=arr.shape)
    mm[:] = arr
    mm.flush()
    return mm


def open_corpus(path: str, vocab_size: int) -> np.memmap:
    return np.memmap(path, dtype=_corpus_dtype(vocab_size), mode="r")


class TokenLoader:
    """Iterate [batch, seq_len + 1] windows over a flat token array.

    Windows tile the corpus end to end (stride seq_len, the +1 overlaps the
    next-token target); a seeded per-epoch permutation shuffles window
    order; trailing windows that don't fill a batch are dropped (static
    shapes).
    """

    def __init__(self, data, batch: int, seq_len: int, seed: int = 0):
        self.data = data
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_windows = (len(data) - 1) // seq_len
        if self.n_windows < batch:
            raise ValueError(f"corpus has {self.n_windows} windows < batch {batch}")
        self.steps_per_epoch = self.n_windows // batch

    def epoch(self, epoch: int, start: int = 0) -> Iterator[np.ndarray]:
        """The batches of `epoch`, from its step `start` on."""
        order = np.random.RandomState(
            np.uint32(self.seed) + np.uint32(epoch)).permutation(self.n_windows)
        W = self.seq_len
        for step in range(start, self.steps_per_epoch):
            idx = order[step * self.batch:(step + 1) * self.batch]
            out = np.empty((self.batch, W + 1), np.int32)
            for i, w in enumerate(idx):
                out[i] = self.data[w * W: w * W + W + 1]
            yield out

    def stream(self, step: int = 0) -> Iterator[np.ndarray]:
        """Every batch from global step `step` on: the batch an
        uninterrupted iteration would give at that step, and the rest."""
        e, offset = divmod(step, self.steps_per_epoch)
        while True:
            yield from self.epoch(e, offset)
            e, offset = e + 1, 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.stream(0)


def prefetch_to_device(it: Iterable[np.ndarray], size: int = 2,
                       device=None) -> Iterator[torch.Tensor]:
    """Wrap a host-batch iterator: keep `size` batches already on their way
    to `device` (the GPU when None; `resolve_device` raises without one).
    On the GPU each batch is copied from pinned memory with
    `non_blocking=True`; the caching host allocator keeps the pinned
    buffer until its copy has run."""
    device = resolve_device(device)
    buf = collections.deque()

    def put(b):
        t = torch.from_numpy(np.asarray(b))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    for b in it:
        buf.append(put(b))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
