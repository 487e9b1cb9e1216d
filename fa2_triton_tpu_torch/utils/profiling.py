"""Observability: profiler traces, roofline accounting (PyTorch port of
`fa2_triton_tpu.utils.profiling`).

`profile_trace` records a `torch.profiler` trace (open the JSON file in
Perfetto or chrome://tracing); `roofline` situates a measured time against
the card's ceilings.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import torch

# Per-card ceilings: dense bf16 tensor-core FLOP/s, HBM bytes/s, and the
# shared memory one thread block may take. H100 SXM, from NVIDIA's data
# sheet (the peaks `chip_smoke.py` scores kernels against).
CHIP_SPECS = {
    "h100": {"bf16_flops": 989e12, "hbm_bw": 3.35e12, "smem_bytes": 227 << 10},
}


def detect_chip() -> str:
    """Normalized name of CUDA device 0: 'h100' for the SXM part
    ('NVIDIA H100 80GB HBM3'), 'h100-pcie', 'h100-nvl', else the name in
    lower case with '-' for spaces; 'cpu' without a CUDA device."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0).lower().replace("nvidia ", "").strip()
    if name.startswith("h100"):
        for part in ("pcie", "nvl"):
            if part in name:
                return f"h100-{part}"
        return "h100"
    return name.replace(" ", "-")


def chip_spec(chip: Optional[str] = None) -> dict:
    """Ceilings for `chip` (detected if None). Unknown cards (an H100 PCIe
    among them: lower clocks and HBM rate than the SXM part) score against
    the H100 SXM with a warning rather than silently mis-scoring."""
    c = chip or detect_chip()
    if c not in CHIP_SPECS:
        warnings.warn(f"no roofline specs for chip {c!r}; scoring against h100 ceilings")
        return CHIP_SPECS["h100"]
    return CHIP_SPECS[c]


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """torch.profiler trace (CPU, and CUDA where there is a device) of the
    enclosed block, written to `<logdir>/trace.<pid>.<ns>.json` on exit
    (`logdir` defaults to `fa2_trace` under the temp directory). Yields the
    logdir."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "fa2_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


@dataclass
class RooflineReport:
    time_s: float
    flops: float
    bytes_moved: float
    chip: str

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.time_s / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_moved / self.time_s / 1e9

    @property
    def compute_bound(self) -> bool:
        spec = chip_spec(self.chip)
        return (self.flops / spec["bf16_flops"]) > (self.bytes_moved / spec["hbm_bw"])

    @property
    def utilization(self) -> float:
        """Fraction of the binding resource's ceiling achieved."""
        spec = chip_spec(self.chip)
        t_ideal = max(self.flops / spec["bf16_flops"],
                      self.bytes_moved / spec["hbm_bw"])
        return t_ideal / self.time_s

    def summary(self) -> str:
        bound = "compute" if self.compute_bound else "bandwidth"
        return (f"{self.achieved_tflops:.1f} TFLOP/s, {self.achieved_gbps:.0f} GB/s "
                f"({bound}-bound on {self.chip}; {self.utilization*100:.0f}% of roofline)")


def roofline(time_s: float, flops: float, bytes_moved: float,
             chip: Optional[str] = None) -> RooflineReport:
    return RooflineReport(time_s, flops, bytes_moved, chip or detect_chip())
