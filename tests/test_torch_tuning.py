"""The port's tuning layer (`ops/tuning.py`, `ops/autotune.py`,
`ops/microsweep.py`) against the JAX package's, and the card's route
entries in the causal routing.

Pure Python on both sides, compared exactly: the block prior over
`tests/test_aux.py`'s grid with the tables off, the table round trip,
tune-on-miss with a fake runner on a fake chip, a table written by JAX's
`record` read back through the port's `lookup`. The route entries are read
from a temporary `h100` table in `$FA2_TUNING_DIR`; the shipped table is
checked against the candidates of its keys' sweep shapes. `BlockSizes`
routes are held against JAX's real dispatch (its schedule entry points
replaced by recorders, as in tests/test_torch_causal_schedules.py and
tests/test_torch_causal_bwd.py).
"""
import itertools
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import fa2_triton_tpu as jfa
from fa2_triton_tpu.ops import autotune as jautotune
from fa2_triton_tpu.ops import flash_bwd as jb
from fa2_triton_tpu.ops import flash_fwd as jf
from fa2_triton_tpu.ops import microsweep as jmicro
from fa2_triton_tpu.ops import tuning as jtuning
from fa2_triton_tpu.utils import round_up_to_multiple

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import autotune, flash_bwd, flash_fwd, microsweep, tuning  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

GRID_S = (128, 255, 1024, 2048, 4096, 8192, 32768)
GRID_FLAGS = ({}, {"has_bias": True}, {"has_window": True}, {"has_varlen": True})


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """An empty $FA2_TUNING_DIR, tables on, tune-on-miss off, caches clear
    on both sides before and after."""
    monkeypatch.setenv("FA2_TUNING_DIR", str(tmp_path))
    for name in ("FA2_DISABLE_TUNING_TABLE", "FA2_TUNE_ON_MISS", "FA2_DISABLE_SPLIT",
                 "FA2_DISABLE_STRIP", "FA2_DISABLE_WL"):
        monkeypatch.delenv(name, raising=False)
    autotune._load_table.cache_clear()
    jautotune._load_table.cache_clear()
    yield tmp_path
    autotune._load_table.cache_clear()
    jautotune._load_table.cache_clear()


def _h100_table(path, entries):
    (path / "tuning_h100.json").write_text(json.dumps(entries))
    autotune._load_table.cache_clear()


# ------------------------------ the prior -----------------------------------

@pytest.mark.parametrize("dtype_bits", [16, 32])
@pytest.mark.parametrize("D", [64, 128, 256, 384])
def test_block_prior_matches_jax(monkeypatch, D, dtype_bits):
    """`choose_block_sizes` and `choose_fused_bwd` over test_aux.py's grid
    (and its padded lengths), tables off on both sides."""
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")
    for S, causal, kw in itertools.product(GRID_S, (False, True), GRID_FLAGS):
        for Sk in (S, 2 * S + 100):
            j = jtuning.choose_block_sizes(S, Sk, D, dtype_bits=dtype_bits, causal=causal, **kw)
            t = tuning.choose_block_sizes(S, Sk, D, dtype_bits=dtype_bits, causal=causal, **kw)
            assert vars(t) == vars(j), (S, Sk, D, dtype_bits, causal, kw)
        Sp = round_up_to_multiple(S, max(j.block_q, j.block_q_bwd))
        Skp = round_up_to_multiple(S, max(j.block_kv, j.block_kv_bwd))
        for a, b in ((Sp, Skp), (Sp, 1280), (384, Skp)):
            assert (tuning.choose_fused_bwd(a, b, D, causal, dtype_bytes=dtype_bits // 8)
                    == jtuning.choose_fused_bwd(a, b, D, causal, dtype_bytes=dtype_bits // 8))
    for block, cap in itertools.product((128, 384, 640, 1024, 3072), (256, 512)):
        assert tuning._divisor_block(block, cap) == jtuning._divisor_block(block, cap)


def test_block_sizes_must_be_lane_aligned():
    tuning.BlockSizes(128, 256, 512, 1024)
    for bad in ((100, 128, 128, 128), (128, 192, 128, 128), (128, 128, 0, 128),
                (128, 128, 128, -128)):
        with pytest.raises(ValueError, match="multiples of 128"):
            tuning.BlockSizes(*bad)


def test_jax_padded_shape_is_the_prior():
    """`flash_fwd.jax_padded_shape` pads to the larger of the prior's
    forward and backward blocks, or to a given BlockSizes'."""
    for S, Sk, D, nbytes in itertools.product((100, 2047, 3000, 7300), (2047, 4100), (64, 256),
                                              (2, 4)):
        Dp = round_up_to_multiple(D, 128)
        b = jtuning.choose_block_sizes(S, Sk, Dp, dtype_bits=8 * nbytes, causal=True)
        want = (round_up_to_multiple(S, max(b.block_q, b.block_q_bwd)),
                round_up_to_multiple(Sk, max(b.block_kv, b.block_kv_bwd)), Dp)
        assert flash_fwd.jax_padded_shape(S, Sk, D, nbytes, chip="cpu") == want
    bs = tuning.BlockSizes(512, 2048, 1024, 256)
    assert flash_fwd.jax_padded_shape(3000, 3000, 128, 2, bs) == (3072, 4096, 128)


# ------------------------------ the tables ----------------------------------

def test_table_round_trip(tables):
    """test_aux.py's round trip on the port: a recorded `fwd` entry is read
    back and overrides the prior's blocks, bucketing keys it, a `fused_bwd`
    entry counts only where it divides, the kill switch turns it off."""
    chip = autotune.detect_chip()
    base = tuning.choose_block_sizes(4096, 4096, 128, causal=False)
    path = autotune.record("fwd", False, 128, 4096, (256, 2048, 1), chip=chip)
    assert path == tables / f"tuning_{chip}.json" and path.exists()
    assert autotune.lookup("fwd", False, 128, 4096, chip=chip) == (256, 2048, 1)
    bs = tuning.choose_block_sizes(4096, 4096, 128, causal=False)
    assert (bs.block_q, bs.block_kv, bs.unroll_kv) == (256, 2048, 1)
    assert (bs.block_q, bs.block_kv) != (base.block_q, base.block_kv)
    assert autotune.lookup("fwd", False, 128, 3000, chip=chip) == (256, 2048, 1)
    assert autotune.lookup("fwd", False, 128, 4097, chip=chip) is None
    autotune.record("fused_bwd", False, 128, 4096, (512, 2048, 512, 2), chip=chip)
    assert tuning.choose_fused_bwd(4096, 4096, 128, False) == (512, 2048, 512, 2)
    assert tuning.choose_fused_bwd(4096, 1280, 128, False) != (512, 2048, 512, 2)
    torch_read = json.loads(path.read_text())
    assert torch_read == {"fwd:0:128:4096": [256, 2048, 1],
                          "fused_bwd:0:128:4096": [512, 2048, 512, 2]}
    for value in ("1", "yes"):
        with pytest.MonkeyPatch.context() as m:
            m.setenv("FA2_DISABLE_TUNING_TABLE", value)
            assert autotune.lookup("fwd", False, 128, 4096, chip=chip) is None


@pytest.mark.parametrize("seqlen", [1, 128, 129, 255, 256, 3000, 4096, 4097, 16383])
def test_keys_and_buckets_match_jax(seqlen):
    assert autotune._bucket(seqlen) == jautotune._bucket(seqlen)
    for kind, variant in (("fwd", ""), ("fwd", "bias"), ("bwd_route", "g4")):
        assert (autotune._key(kind, True, 128, seqlen, variant)
                == jautotune._key(kind, True, 128, seqlen, variant))


def test_a_jax_table_reads_the_same_in_the_port(tables):
    """Entries written by JAX's `record` (tile and route kinds) come back
    unchanged through the port's `lookup`, and the reverse."""
    jautotune.record("bwd_route", True, 128, 8192, ("generic",), chip="h100", variant="g1")
    jautotune.record("fwd", True, 256, 2048, (512, 512, 1), chip="h100")
    autotune._load_table.cache_clear()
    assert autotune.lookup("bwd_route", True, 128, 8191, chip="h100", variant="g1") == ("generic",)
    assert autotune.lookup("fwd", True, 256, 2000, chip="h100") == (512, 512, 1)
    autotune.record("fwd_route", True, 64, 4096, ("generic",), chip="h100")
    jautotune._load_table.cache_clear()
    assert jautotune.lookup("fwd_route", True, 64, 4095, chip="h100") == ("generic",)
    assert jautotune.lookup("bwd_route", True, 128, 8192, chip="h100", variant="g1") == ("generic",)


def test_tune_on_miss_with_a_fake_runner(tables, monkeypatch):
    """test_aux.py's tune-on-miss on the port: a miss on a fake chip runs
    the runner once, on the bucket, and persists its winner; 'cpu' and
    'unknown' never sweep; a variant key never sweeps."""
    monkeypatch.setenv("FA2_TUNE_ON_MISS", "1")
    calls = []

    def fake_runner(kind, causal, head_dim, seqlen):
        calls.append((kind, causal, head_dim, seqlen))
        return ("generic",) if kind == "fwd_route" else (256, 1024, 1)

    monkeypatch.setattr(autotune, "_sweep_runner", fake_runner)
    assert autotune.lookup("fwd", False, 128, 4096, chip="v9z") == (256, 1024, 1)
    assert calls == [("fwd", False, 128, 4096)]
    assert (tables / "tuning_v9z.json").exists()
    assert autotune.lookup("fwd", False, 128, 4096, chip="v9z") == (256, 1024, 1)
    assert len(calls) == 1
    for chip in ("cpu", "unknown"):
        assert autotune.lookup("fwd", False, 128, 2048, chip=chip) is None
    assert autotune.lookup("bwd_route", True, 128, 2048, chip="v9z", variant="g1") is None
    assert len(calls) == 1
    assert autotune.lookup("fwd_route", True, 128, 3000, chip="v9z") == ("generic",)
    assert calls[-1] == ("fwd_route", True, 128, 4096)
    assert json.loads((tables / "tuning_v9z.json").read_text())["fwd_route:1:128:4096"] == [
        "generic"]


def test_detect_chip_names_the_device(monkeypatch):
    """CPU devices are 'cpu' even beside a card; CUDA devices are named by
    their card (device 0 when none is given)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA H100 PCIe"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: names[i])
    assert autotune.detect_chip(torch.device("cpu")) == "cpu"
    assert autotune.detect_chip("cpu") == "cpu"
    assert autotune.detect_chip() == "h100"
    assert autotune.detect_chip(torch.device("cuda", 1)) == "h100-pcie"
    assert autotune.detect_chip("cuda") == "h100"


def test_warn_if_unswept_warns_once_on_a_card_without_a_table(tables):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for chip in ("cpu", "unknown", "a100-x", "a100-x"):
            autotune.warn_if_unswept(chip)
        _h100_table(tables, {"fwd_route:1:128:4096": ["generic"]})
        autotune.warn_if_unswept("h100")
    assert [str(w.message).split(":")[0] for w in seen] == [
        "fa2_triton_tpu_torch has no tuning table for a100-x"]


# ------------------------------ route entries -------------------------------

PLAIN = dict(causal=True, static_skip=True)


def test_forward_route_takes_each_entry(tables):
    """Each entry where its gate passes; the prior where it fails; a
    generic entry always; no chip, or 'cpu', never reads the table."""
    _h100_table(tables, {"fwd_route:1:128:4096": ["generic"], "fwd_route:1:128:2048": ["strip"],
                         "fwd_route:1:128:1024": ["split"], "fwd_route:1:64:8192": ["strip"],
                         "fwd_route:1:256:2048": ["tri_square"]})
    route = lambda S, D=128, **kw: flash_fwd.forward_route(S, S, D, 2, **{**PLAIN, **kw})  # noqa
    assert route(4095) == "split" and route(4095, chip="cpu") == "split"
    assert route(4095, chip="h100") == "generic"
    assert route(2047) == "tri_square" and route(2047, chip="h100") == "strip"
    assert route(1000, chip="h100") == "tri_square"        # split's gate fails at 1024
    assert route(8191, D=64, chip="h100") == "generic"     # strip's gate fails at 8192
    assert route(2047, D=256, chip="h100") == "split"      # tri-square's gate fails at D 256
    assert route(3000, chip="h100") == "generic"           # bucket 4096, where the split's fails
    assert route(3000) == "strip"


def test_backward_route_takes_each_entry(tables):
    _h100_table(tables, {"bwd_route+g1:1:128:8192": ["generic"],
                         "bwd_route+g1:1:128:2048": ["strip"],
                         "bwd_route+g1:1:128:4096": ["split"],
                         "bwd_route+g4:1:128:2048": ["tri_square"],
                         "bwd_route+g4:1:128:512": ["generic"],
                         "bwd_route+g1:1:256:4096": ["worklist"]})
    route = lambda S, group=1, D=128, **kw: flash_bwd.backward_route(  # noqa: E731
        S, S, D, 2, group=group, **{**PLAIN, **kw})
    assert route(8191) == "worklist" and route(8191, chip="h100") == "generic"
    assert route(2047, chip="h100") == "strip"
    assert route(4095) == "generic" and route(4095, chip="h100") == "split"
    assert route(2047, group=4, chip="h100") == "strip"    # the g4 tri-square's gate fails
    assert route(511, group=4, chip="h100") == "generic"
    assert route(4095, D=256, chip="h100") == "worklist"
    assert route(6143) == "worklist" and route(6143, chip="h100") == "generic"   # bucket 8192


def test_calls_the_table_skips(tables):
    """Bias, window, softcap, varlen, fp32, a non-static shift, a forced
    route or split leaf, or any kill switch: the prior decides."""
    _h100_table(tables, {"fwd_route:1:128:4096": ["generic"],
                         "bwd_route+g1:1:128:8192": ["generic"]})
    def f(nbytes=2, **kw):
        return flash_fwd.forward_route(4095, 4095, 128, nbytes, **{**PLAIN, "chip": "h100", **kw})

    def b(nbytes=2, **kw):
        return flash_bwd.backward_route(8191, 8191, 128, nbytes,
                                        **{**PLAIN, "chip": "h100", **kw})
    assert f() == "generic" and b() == "generic"
    skips = (dict(window=(100, -1)), dict(softcap=5.0), dict(varlen=True),
             dict(static_skip=False), dict(nbytes=4))
    for kw in skips:
        assert f(**kw) == flash_fwd.forward_route(4095, 4095, 128, kw.get("nbytes", 2), **{
            **PLAIN, **{k: x for k, x in kw.items() if k != "nbytes"}}), kw
        assert b(**kw) == flash_bwd.backward_route(8191, 8191, 128, kw.get("nbytes", 2), **{
            **PLAIN, **{k: x for k, x in kw.items() if k != "nbytes"}}), kw
    assert b(window=(100, -1)) == "worklist"
    _h100_table(tables, {"fwd_route:1:128:1024": ["generic"]})
    for kw in (dict(), dict(nbytes=4), dict(varlen=True)):
        want = "generic" if not kw else "tri_square"
        assert flash_fwd.forward_route(1000, 1000, 128, kw.pop("nbytes", 2), chip="h100",
                                       **PLAIN, **kw) == want
    assert f(bias="bias") == "generic"
    assert f(causal_split=True) == "split" and f(causal_strip=True, causal_split=False) == "strip"
    assert f(split_leaf=2048) == "split" and f(route="split") == "split"
    assert b(causal_split=False) == "worklist" and b(split_leaf=2048) == "split"
    assert b(route="worklist") == "worklist"
    for env, fwd, bwd in (("FA2_DISABLE_STRIP", "split", "worklist"),
                          ("FA2_DISABLE_SPLIT", "strip", "worklist"),
                          ("FA2_DISABLE_WL", "split", "generic")):
        with pytest.MonkeyPatch.context() as m:
            m.setenv(env, "1")
            assert (f(), b()) == (fwd, bwd), env
    with pytest.MonkeyPatch.context() as m:
        m.setenv("FA2_DISABLE_TUNING_TABLE", "1")
        assert (f(), b()) == ("split", "worklist")


def test_forced_routes_by_name():
    assert flash_fwd.forward_route(4095, 4095, 128, 2, route="generic", **PLAIN) == "generic"
    assert flash_fwd.forward_route(4095, 4095, 128, 2, route="strip", **PLAIN) == "strip"
    assert flash_bwd.backward_route(2047, 2047, 128, 2, route="strip", **PLAIN) == "strip"
    assert flash_bwd.backward_route(8191, 8191, 128, 2, route="split", **PLAIN) == "split"
    for fn, S, bad in ((flash_fwd.forward_route, 8191, "strip"),
                       (flash_bwd.backward_route, 2047, "worklist")):
        with pytest.raises(ValueError, match="forced"):
            fn(S, S, 128, 2, route=bad, **PLAIN)
        with pytest.raises(ValueError, match="unknown"):
            fn(S, S, 128, 2, route="fused", **PLAIN)
    with pytest.raises(ValueError, match="bias"):
        flash_bwd.backward_route(2047, 2047, 128, 2, route="strip", bias="b", **PLAIN)


def test_cpu_tensors_never_read_the_table(tables, monkeypatch):
    """A 'cpu' table naming every key generic does not move a CPU call
    through `flash_attn_func` off the prior's route (the split here)."""
    (tables / "tuning_cpu.json").write_text(json.dumps({
        "fwd_route:1:128:4096": ["generic"], "bwd_route+g1:1:128:4096": ["generic"]}))
    autotune._load_table.cache_clear()
    seen = []
    real = flash_fwd.forward_route
    monkeypatch.setattr(flash_fwd, "forward_route",
                        lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1])
    monkeypatch.setattr(flash_fwd, "_causal_split_forward", _recorder("split"))
    with pytest.raises(_Routed, match="split"):
        flash_attn_func(*(torch.zeros(1, 4095, 2, 128, dtype=torch.bfloat16),) * 3, causal=True)
    assert seen == ["split"]


# ----------------------- BlockSizes against JAX's dispatch ------------------

class _Routed(Exception):
    pass


def _recorder(route):
    def record(*args, **kwargs):
        raise _Routed(route)
    return record


BLOCK_CASES = [(3000, (2048, 2048, 2048, 2048)), (2100, (128, 128, 128, 128)),
               (2047, (512, 512, 512, 512)), (4000, (256, 1024, 1024, 256)),
               (6000, (1024, 1024, 2048, 2048)), (1500, (1024, 512, 1024, 1024)),
               (2047, (4096, 4096, 128, 128)), (5000, (8192, 8192, 128, 128))]


def test_block_sizes_route_the_forward_as_jax_does(monkeypatch):
    """`flash_attn_func(block_sizes=...)` in both packages, each package's
    schedules replaced by recorders (JAX's generic kernel by a recording
    pallas_call): the same route, and not always the default's."""
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")
    for name, route in (("flash_attn_forward_tri_square", "tri_square"),
                        ("_causal_split_forward", "split"),
                        ("flash_attn_forward_causal_strip", "strip")):
        monkeypatch.setattr(jf, name, _recorder(route))
        monkeypatch.setattr(flash_fwd, name, _recorder(route))
    monkeypatch.setattr(jf.pl, "pallas_call", _recorder("generic"))
    monkeypatch.setattr(flash_fwd, "_generic_forward", _recorder("generic"))
    moved = 0
    for S, blocks in BLOCK_CASES:
        routes = []
        for fa, zeros, bs in (
                (jfa.flash_attn_func, lambda s: jnp.zeros((1, s, 2, 128), jnp.bfloat16),
                 jtuning.BlockSizes(*blocks)),
                (flash_attn_func, lambda s: torch.zeros(1, s, 2, 128, dtype=torch.bfloat16),
                 tuning.BlockSizes(*blocks))):
            with pytest.raises(_Routed) as rec:
                fa(zeros(S), zeros(S), zeros(S), causal=True, block_sizes=bs)
            routes.append(rec.value.args[0])
        assert routes[0] == routes[1], (S, blocks, routes)
        moved += routes[1] != flash_fwd.forward_route(S, S, 128, 2, **PLAIN)
    assert moved >= 4


def test_block_sizes_route_the_backward_as_jax_does(monkeypatch):
    """`backward_route(block_sizes=...)` against JAX's real backward
    dispatch on zero-stride stand-ins of the arrays its API pads to under
    the same blocks."""
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")
    for name, route in (("flash_attn_backward_tri_square", "tri_square"),
                        ("_causal_split_backward", "split"),
                        ("flash_attn_backward_causal_strip", "strip"),
                        ("flash_attn_backward_fused_wl", "worklist")):
        monkeypatch.setattr(jb, name, _recorder(route))
    monkeypatch.setattr(jtuning, "choose_fused_bwd", _recorder("generic"))
    seen = set()
    for (S, blocks), group in itertools.product(BLOCK_CASES + [(8000, (512, 512, 512, 512))],
                                                (1, 4)):
        bs = jtuning.BlockSizes(*blocks)
        Sp = round_up_to_multiple(S, max(bs.block_q, bs.block_q_bwd))
        Skp = round_up_to_multiple(S, max(bs.block_kv, bs.block_kv_bwd))
        zeros = lambda h, s: np.broadcast_to(np.zeros((), jnp.bfloat16), (1, h, s, 128))  # noqa
        q, k = zeros(group, Sp), zeros(1, Skp)
        with pytest.raises(_Routed) as rec:
            jb.flash_attn_backward(q, k, k, q, q, None, None, None, None, causal=True,
                                   softmax_scale=0.1, seqlen_q_real=S, seqlen_k_real=S,
                                   static_skip=True)
        got = flash_bwd.backward_route(S, S, 128, 2, group=group, block_sizes=tuning.BlockSizes(
            *blocks), **PLAIN)
        assert got == rec.value.args[0], (S, blocks, group)
        seen.add(got)
    assert seen >= {"tri_square", "strip", "generic"}


# ------------------------------ the micro-sweep -----------------------------

def test_sweep_candidates_and_shapes():
    """Tile kinds have no candidates on the card; route kinds list the
    routes whose gates pass at the sweep shape, in the prior's order,
    which contain the prior's route."""
    assert microsweep.sweep_shape(4096, 128, "g4") == dict(B=1, Hq=32, Hkv=8, S=4095, D=128)
    assert microsweep.sweep_shape(512, 64) == dict(B=8, Hq=32, Hkv=32, S=511, D=64)
    for kind in ("fwd", "fused_bwd", "strip_fwd", "strip_bwd", "diag_fwd", "rect_bwd"):
        assert microsweep.candidates(kind, True, 128, 4096) == ()
        assert jmicro.candidates(kind, True, 128, 4096) == jmicro.candidates(kind, True, 128,
                                                                            4096)
    assert microsweep.candidates("fwd_route", False, 128, 4096) == ()
    assert microsweep.candidates("fwd_route", True, 128, 4096) == (
        ("split",), ("strip",), ("generic",))
    assert microsweep.candidates("bwd_route", True, 128, 8192, "g1") == (
        ("split",), ("worklist",), ("generic",))
    assert microsweep.candidates("bwd_route", True, 128, 2048, "g4") == (
        ("strip",), ("generic",))
    for kind, variant, D, bucket in itertools.product(
            ("fwd_route", "bwd_route"), ("g1", "g4"), (64, 128, 256), (512, 2048, 8192)):
        v = variant if kind == "bwd_route" else ""
        routes = [c[0] for c in microsweep.candidates(kind, True, D, bucket, v)]
        assert microsweep.prior_route(kind, D, bucket, v) in routes and routes[-1] == "generic"


def test_decide_needs_a_margin_beyond_the_spread():
    t = {"tri_square": [1.00, 1.02, 1.01, 1.00, 1.03], "generic": [0.99, 1.00, 0.98, 1.00, 0.99]}
    assert microsweep.decide(t, "tri_square") == "tri_square"      # 0.01 < the 0.03 spread
    t["generic"] = [0.90, 0.91, 0.90, 0.92, 0.90]
    assert microsweep.decide(t, "tri_square") == "generic"         # 0.10 > 0.03
    assert microsweep.decide(t, "generic") == "generic"
    assert microsweep.decide({"generic": [1.0] * 5}, "split") == "generic"   # the prior failed
    assert microsweep.decide({}, "generic") is None
    assert microsweep.median([3, 1, 2, 4]) == 2.5 and microsweep.spread([3, 1, 2]) == 2


def test_measurement_needs_a_card():
    for fn in (lambda: microsweep.measure_config("fwd_route", True, 128, 512, ("generic",),
                                                 device="cpu"),
               lambda: microsweep.time_candidates("bwd_route", True, 128, 512, "g1",
                                                  device="cpu")):
        with pytest.raises(ValueError, match="CUDA"):
            fn()
    assert microsweep.run_micro_sweep("fwd", True, 128, 4096) is None   # a tile kind


def test_sweep_times_by_the_tensors_it_is_given(monkeypatch):
    """Every timed call hands `device_time` the tensors it runs on, so on
    the card it times by CUDA events (a call without tensor arguments is
    timed by the host clock, which does not wait for the launches); each
    candidate runs `runs` times, in turns. Tiny shapes, on the CPU."""
    from fa2_triton_tpu_torch.utils import benchmarking

    seen = []

    def fake_device_time(fn, *args, **kw):
        assert any(isinstance(a, torch.Tensor) for a in args), "no tensor arguments"
        fn(*args)
        seen.append(len(args))
        return 1e-3

    monkeypatch.setattr(benchmarking, "device_time", fake_device_time)
    monkeypatch.setattr(microsweep, "_check_device", torch.device)
    monkeypatch.setattr(microsweep, "SWEEP_HEADS", 2)
    monkeypatch.setattr(microsweep, "SWEEP_TOKENS", 128)
    times = microsweep.time_candidates("bwd_route", True, 64, 256, "g1", runs=5, device="cpu")
    assert {r: len(t) for r, t in times.items()} == {"tri_square": 5, "generic": 5}
    assert len(microsweep.sdpa_flash_ms("fwd_route", 64, 256, runs=2, device="cpu")) == 2
    assert microsweep.measure_config("fwd_route", True, 64, 256, ("generic",), device="cpu") \
        == 1e-3
    assert len(seen) == 13


def test_shipped_h100_table():
    """The shipped table parses; every key is a route key of a swept
    bucket, head dim and group, and every value a route eligible at its
    key's sweep shape."""
    path = autotune.table_paths("h100")[0]
    table = json.loads(path.read_text())
    assert table
    for key, value in table.items():
        kind, causal, D, bucket = key.split(":")
        kind, _, variant = kind.partition("+")
        assert kind in microsweep.ROUTE_KINDS and causal == "1", key
        assert (variant in ("g1", "g4")) == (kind == "bwd_route"), key
        assert int(D) in (64, 128, 256) and int(bucket) in (512, 1024, 2048, 4096, 8192, 16384)
        assert isinstance(value, list) and len(value) == 1, key
        assert tuple(value) in microsweep.candidates(kind, True, int(D), int(bucket), variant), key
