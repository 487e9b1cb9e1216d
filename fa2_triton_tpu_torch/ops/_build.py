"""Build and load the hand-written CUDA kernels in `fa2_triton_tpu_torch/csrc/`.

Each `csrc/*.cu` file is compiled by its own `nvcc` for `sm_90a`, all at
once, and the objects are linked into one shared library with a plain C
interface, which is loaded with `ctypes`. The library
lands in `build/fa2_triton_tpu_torch/<hash of the sources>/` at the root of
the checkout, so an edited source builds anew and an unchanged one is built
once. Nothing is built at import: the first kernel launch calls `load()`.

There is no fallback. Without `nvcc` the build raises; the op wrappers take
their plain PyTorch path only for CPU tensors, never because a build failed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fa2_triton_tpu_torch"
LIB_NAME = "libfa2kernels.so"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the CUDA toolkit's default prefix
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# dtype codes of the C entry points (`enum DType` in csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
# nvcc's output of the last `build(verbose=True)`: ptxas registers, shared
# memory and spills of every kernel.
ptxas_report: Optional[str] = None


class KernelBuildError(RuntimeError):
    pass


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the toolkit's
    default install prefix. Raises KernelBuildError when none exists."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(Path(os.environ[env]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        f"nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, $PATH and "
        f"{DEFAULT_NVCC}): the CUDA kernels of fa2_triton_tpu_torch need "
        "the CUDA toolkit to build. CPU tensors use the plain PyTorch path "
        "and need no build.")


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists: one
    nvcc per source file, all started together, then one link.
    `verbose=True` adds `-Xptxas -v` and prints nvcc's output (registers,
    shared memory and spills of each kernel). Returns the library path."""
    global build_seconds, ptxas_report
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file() and not verbose:
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for cu in sorted(CSRC.glob("*.cu")):
        obj, log = out_dir / f"{cu.stem}.{tag}.o", out_dir / f"{cu.stem}.{tag}.log"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-c", "-o", str(obj), str(cu)]
        with open(log, "w") as fh:
            jobs.append((cmd, obj, log, subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)))
    reports, failed = [], []
    for cmd, obj, log, proc in jobs:
        proc.wait()
        reports.append(log.read_text())
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{reports[-1]}")
    objs = [obj for _, obj, _, _ in jobs]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    try:
        if failed:
            raise KernelBuildError("\n".join(failed))
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        ptxas_report = "\n".join(reports)
        print(ptxas_report)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def find_cuobjdump() -> Optional[str]:
    """cuobjdump beside nvcc (the CUDA toolkit), else the copy in Triton's
    package (`triton/backends/nvidia/bin/`), else None."""
    try:
        candidates = [Path(find_nvcc()).parent / "cuobjdump"]
    except KernelBuildError:
        candidates = []
    try:
        import importlib.util
        spec = importlib.util.find_spec("triton")
        if spec is not None and spec.origin:
            candidates.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except (ImportError, ValueError):
        pass
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def load() -> ctypes.CDLL:
    """Build if needed, then load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fa2_error_string.argtypes = [ctypes.c_int]
        lib.fa2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if status != 0:
        msg = load().fa2_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
