"""The ctypes argument lists of the PyTorch port's wrappers against the C
entry points they call. ctypes passes whatever the argtypes say: an argument
list one entry short, or an int where the C side takes a long long, hands
the kernel garbage with no error. So every `extern "C" int fa2_*(...)` in
`fa2_triton_tpu_torch/csrc/*.cu` is parsed, each parameter mapped to its
ctypes kind, and the list compared with the argtypes each wrapper sets on
the library, recorded through a stand-in library in place of
`_build.load` (no build, no GPU).
"""
import ctypes
import re
import types

import pytest

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import _build, decode, flash_bwd, flash_fwd, varlen  # noqa: E402

_ENTRY = re.compile(r'extern "C" int (fa2_\w+)\(([^)]*)\)', re.S)


def _kind(param: str):
    """The ctypes type of one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kinds = (("unsigned int", ctypes.c_uint), ("long long", ctypes.c_longlong),
             ("float", ctypes.c_float), ("int", ctypes.c_int))
    for c_type, kind in kinds:
        if decl.startswith(c_type + " "):
            return kind
    raise AssertionError(f"no ctypes kind for the C parameter {param!r}")


def _c_signatures():
    """{entry point: [ctypes kind of each parameter]} from csrc/*.cu."""
    out = {}
    for path in _build.CSRC.glob("*.cu"):
        for name, params in _ENTRY.findall(path.read_text()):
            assert name not in out, f"{name} defined twice"
            out[name] = [_kind(p) for p in params.split(",")]
    return out


def _wrapper_argtypes(monkeypatch):
    """{entry point: argtypes} as the wrappers set them on a stand-in library."""
    lib = types.SimpleNamespace()
    monkeypatch.setattr(_build, "load", lambda: lib)
    for name in _c_signatures():
        setattr(lib, name, types.SimpleNamespace())
    monkeypatch.setattr(flash_fwd, "_c_fns", {})
    monkeypatch.setattr(flash_bwd, "_c_fns", {})
    monkeypatch.setattr(decode, "_c_fn", None)
    monkeypatch.setattr(varlen, "_c_fn", None)
    for name in flash_fwd._ARGTYPES:
        flash_fwd._entry(name)
    for name in flash_bwd._ARGTYPES:
        flash_bwd._entry(name)
    decode._entry()
    varlen._entry()
    return {name: list(fn.argtypes) for name, fn in vars(lib).items() if hasattr(fn, "argtypes")}


def test_every_entry_point_has_a_wrapper_with_its_argtypes(monkeypatch):
    c_sigs = _c_signatures()
    assert {"fa2_flash_fwd", "fa2_flash_fwd_causal", "fa2_flash_fwd_rect", "fa2_flash_bwd",
            "fa2_flash_bwd_tri", "fa2_flash_bwd_wl", "fa2_decode", "fa2_varlen"} <= set(c_sigs)
    wrappers = _wrapper_argtypes(monkeypatch)
    assert set(wrappers) == set(c_sigs)
    for name, kinds in c_sigs.items():
        assert wrappers[name] == kinds, (name, len(wrappers[name]), len(kinds))


def test_the_parse_sees_each_kind():
    """The parser reads the forward's signature as its declaration says: the
    tile rows and the stream close it, the strides are long long, the
    dropout seed and threshold unsigned."""
    fwd = _c_signatures()["fa2_flash_fwd"]
    assert fwd[-2:] == [ctypes.c_int, ctypes.c_void_p]
    assert fwd.count(ctypes.c_longlong) == 16 and fwd.count(ctypes.c_uint) == 2
    assert fwd.count(ctypes.c_float) == 3


def test_tile_rows_match_the_forward_kernels():
    """The host counts q tiles in TILE_ROWS (the schedules' alignment, the
    strip's shift rule); both forward kernels of csrc/flash_fwd.cu take it as
    an argument and refuse the launch unless it is their block's rows (the
    tensor-core kernel's `FwdMmaCfg`, in csrc/fwd_mma.cuh)."""
    tm = int(re.search(r"constexpr int TM = (\d+);", (_build.CSRC / "attn_tiles.cuh").read_text())[1])
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    assert flash_fwd.TILE_ROWS == tm
    assert "static constexpr int BQ = TM;" in (_build.CSRC / "fwd_mma.cuh").read_text()
    assert "if (p.tile_rows != TM) return cudaErrorInvalidValue;" in src
    assert "if (p.tile_rows != C::BQ) return cudaErrorInvalidValue;" in src
