"""Persisted per-chip tuning tables (PyTorch port of
`fa2_triton_tpu.ops.autotune`).

The JAX package keeps a baked-in prior (the v5e sweeps in `ops/tuning.py`
and the VMEM gates of the causal schedules) and lets a persisted table per
chip override it, swept on that chip (`ops/microsweep.py`). The port keeps
the same mechanism, the same table format and the same switches, so a
table written by one package reads the same in the other:

* a table is a JSON object mapping `kind[+variant]:causal:head_dim:bucket`
  to a list (`_key`; the bucket is the power of two at or above the
  sequence length, at least 128);
* the shipped `fa2_triton_tpu_torch/ops/tables/tuning_<chip>.json` is
  overlaid by `$FA2_TUNING_DIR/tuning_<chip>.json` (default directory
  `~/.cache/fa2_triton_tpu_torch`), where `record` writes;
* `FA2_DISABLE_TUNING_TABLE` (any non-empty value) turns every lookup off;
  `FA2_TUNE_ON_MISS` (any non-empty value) sweeps a missing key without a
  variant once on the current card and persists the winner.

On the card the CUDA tiles are compile-time, so the only thing a table can
choose at run time is the schedule: `fwd_route` and `bwd_route` entries
(`ops/flash_fwd.py:forward_route`, `ops/flash_bwd.py:backward_route`) hold
one route name, `["generic"]` for example. JAX's tile kinds (`fwd`,
`fused_bwd`, `strip_*`) are read where JAX reads them and decide the padded
shape the prior's gates see (`ops/tuning.py`).
"""
from __future__ import annotations

import functools
import json
import os
import warnings
from pathlib import Path
from typing import Optional

import torch


def _tuning_dir() -> Path:
    return Path(os.environ.get(
        "FA2_TUNING_DIR", os.path.expanduser("~/.cache/fa2_triton_tpu_torch")))


@functools.lru_cache(maxsize=None)
def _chip_of_name(name: str) -> str:
    name = name.lower().replace("nvidia ", "").strip()
    if name.startswith("h100"):
        for part in ("pcie", "nvl"):
            if part in name:
                return f"h100-{part}"
        return "h100"
    return name.replace(" ", "-")


def detect_chip(device=None) -> str:
    """Normalized name of the chip that holds `device` (CUDA device 0 when
    None): 'h100' for the SXM part ('NVIDIA H100 80GB HBM3'), 'h100-pcie',
    'h100-nvl', else the card's name in lower case with '-' for spaces;
    'cpu' for a CPU device, even on a machine with a card, and without a
    CUDA device."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    index = 0 if device is None or device.index is None else device.index
    return _chip_of_name(torch.cuda.get_device_name(index))


def _bucket(seqlen: int) -> int:
    """Power-of-two sequence-length bucket, at least 128 (JAX's key)."""
    b = 128
    while b < seqlen:
        b *= 2
    return b


def _key(kind: str, causal: bool, head_dim: int, seqlen: int,
         variant: str = "") -> str:
    tag = f"+{variant}" if variant else ""
    return f"{kind}{tag}:{int(causal)}:{head_dim}:{_bucket(seqlen)}"


def table_paths(chip: str):
    """(shipped table, user table) of `chip`, in overlay order."""
    return (Path(__file__).parent / "tables" / f"tuning_{chip}.json",
            _tuning_dir() / f"tuning_{chip}.json")


@functools.lru_cache(maxsize=8)
def _load_table(chip: str) -> dict:
    """The shipped table overlaid by the user's ($FA2_TUNING_DIR)."""
    table = {}
    for path in table_paths(chip):
        if path.exists():
            try:
                table.update(json.loads(path.read_text()))
            except (json.JSONDecodeError, OSError) as e:
                warnings.warn(f"ignoring unreadable tuning table {path}: {e}")
    return table


def lookup(kind: str, causal: bool, head_dim: int, seqlen: int,
           chip: Optional[str] = None, variant: str = "") -> Optional[tuple]:
    """Persisted override for a config, or None.

    kind: 'fwd' -> (block_q, block_kv, unroll_kv);
          'fused_bwd' -> (block_q, block_kv, sub_kv, unroll);
          'strip_fwd' / 'strip_bwd' -> (sub, wide);
          'fwd_route' / 'bwd_route' -> (route,).
    """
    if os.environ.get("FA2_DISABLE_TUNING_TABLE"):
        return None
    chip = chip or detect_chip()
    entry = _load_table(chip).get(_key(kind, causal, head_dim, seqlen, variant))
    if entry is None and not variant and os.environ.get("FA2_TUNE_ON_MISS"):
        entry = _tune_on_miss(kind, causal, head_dim, seqlen, chip)
    return tuple(entry) if entry is not None else None


# Pluggable micro-sweep runner (tests substitute a fake; None = the real one).
_sweep_runner = None
_misses_in_progress: set = set()


def _tune_on_miss(kind: str, causal: bool, head_dim: int, seqlen: int, chip: str):
    """Opt-in (FA2_TUNE_ON_MISS=1) one-shot sweep of an unswept (chip, kind,
    head_dim, bucket) key on the current card; the winner is persisted, so
    later processes skip the sweep. Never on 'cpu' or 'unknown': host
    timing of the plain twins would tune nothing real."""
    if chip in ("cpu", "unknown"):
        return None
    key = _key(kind, causal, head_dim, seqlen)
    if key in _misses_in_progress:
        return None  # the sweep itself dispatches kernels: no recursion
    _misses_in_progress.add(key)
    try:
        runner = _sweep_runner
        if runner is None:
            from fa2_triton_tpu_torch.ops.microsweep import run_micro_sweep
            runner = run_micro_sweep
        best = runner(kind, causal, head_dim, _bucket(seqlen))
        if best is not None:
            record(kind, causal, head_dim, seqlen, tuple(best), chip=chip)
        return best
    finally:
        _misses_in_progress.discard(key)


def record(kind: str, causal: bool, head_dim: int, seqlen: int,
           config: tuple, chip: Optional[str] = None,
           variant: str = "") -> Path:
    """Persist a swept winner into the user table; returns its path."""
    chip = chip or detect_chip()
    path = table_paths(chip)[1]
    path.parent.mkdir(parents=True, exist_ok=True)
    table = dict(_load_table(chip))
    table[_key(kind, causal, head_dim, seqlen, variant)] = list(config)
    path.write_text(json.dumps(table, indent=1, sort_keys=True))
    _load_table.cache_clear()
    return path


_warned_chips: set = set()


def warn_if_unswept(chip: Optional[str] = None) -> None:
    """One-time warning on a CUDA chip that has no table of its own: its
    routes are the prior's, JAX's v5e gates, unmeasured on that card."""
    chip = chip or detect_chip()
    if chip in ("cpu", "unknown") or chip in _warned_chips:
        return
    if _load_table(chip):
        return
    _warned_chips.add(chip)
    warnings.warn(
        f"fa2_triton_tpu_torch has no tuning table for {chip}: its causal routes are the "
        f"prior's (the JAX package's v5e gates), unmeasured on this card. Sweep one with "
        f"`python -m fa2_triton_tpu_torch.ops.microsweep --out $FA2_TUNING_DIR`.")
