"""The port's roofline accounting, profiler trace and timer
(`utils/profiling.py`, `utils/benchmarking.py`): `test_aux.py`'s roofline
test on the H100's ceilings, the report's arithmetic against the JAX
package's `RooflineReport` fed the same ceilings (exact: the same float
operations), the unknown-card warning, a written trace and a CPU time. No
time here is a device's: the CPU run only checks that a positive number
comes back."""
import json
import warnings

import pytest

from fa2_triton_tpu.utils import profiling as jprof

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.utils import profiling as tprof  # noqa: E402
from fa2_triton_tpu_torch.utils.benchmarking import device_time  # noqa: E402
from fa2_triton_tpu_torch.utils.profiling import (  # noqa: E402
    CHIP_SPECS, chip_spec, detect_chip, profile_trace, roofline)


def test_roofline_report():
    r = roofline(time_s=1e-3, flops=500e9, bytes_moved=100e6, chip="h100")
    assert r.compute_bound
    assert 0 < r.utilization < 1
    assert "TFLOP/s" in r.summary() and "on h100" in r.summary()


def test_h100_ceilings_are_the_smoke_scripts():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    h100 = CHIP_SPECS["h100"]
    assert h100["bf16_flops"] == smoke.PEAK_BF16_FLOPS
    assert h100["hbm_bw"] == smoke.PEAK_HBM_BYTES_S
    assert h100["smem_bytes"] == 227 * 1024


@pytest.mark.parametrize("time_s,flops,nbytes", [(1e-3, 500e9, 100e6), (2e-3, 1e9, 4e9),
                                                 (0.7, 6 * 1.14e9 * 4094, 4 * 1.14e9)])
def test_report_arithmetic_equals_jax(monkeypatch, time_s, flops, nbytes):
    monkeypatch.setitem(jprof.CHIP_SPECS, "h100", {**CHIP_SPECS["h100"]})
    want, got = jprof.RooflineReport(time_s, flops, nbytes, "h100"), roofline(
        time_s, flops, nbytes, chip="h100")
    for name in ("achieved_tflops", "achieved_gbps", "compute_bound", "utilization"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.summary() == want.summary()


@pytest.mark.parametrize("name,chip", [("NVIDIA H100 80GB HBM3", "h100"),
                                       ("NVIDIA H100 PCIe", "h100-pcie"),
                                       ("NVIDIA H100 NVL", "h100-nvl"),
                                       ("NVIDIA A100-SXM4-80GB", "a100-sxm4-80gb")])
def test_detect_chip_reads_the_card_name(monkeypatch, name, chip):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    assert detect_chip() == chip
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert chip_spec() == CHIP_SPECS["h100"]
    assert (len(seen) == 1 and "scoring against h100" in str(seen[0].message)) == (chip != "h100")


def test_cpu_is_an_unknown_chip():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert detect_chip() == "cpu"
    with pytest.warns(UserWarning, match="no roofline specs for chip 'cpu'"):
        tprof.chip_spec()


def test_profile_trace_writes_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path / "trace")) as logdir:
        (x @ x).sum()
    files = list((tmp_path / "trace").iterdir())
    assert logdir == str(tmp_path / "trace") and len(files) == 1
    trace = json.loads(files[0].read_text())
    assert any("aten::mm" in str(e.get("name")) for e in trace["traceEvents"])


def test_device_time_on_the_cpu_is_positive():
    x = torch.randn(128, 128)
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    t = device_time(fn, x, iters=4, reps=3, min_window=1e-4)
    assert t > 0 and len(calls) >= 1 + 3 * 4
