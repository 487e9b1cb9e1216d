"""The port's parallel attention (`fa2_triton_tpu_torch/parallel/`: ring,
Ulysses and TP attention over `torch.distributed`) against the JAX package
on the CPU.

The port's cases run in two spawned worlds of gloo CPU ranks (2 and 4),
each once for the module, while the JAX references are computed in the
meantime: JAX's own `make_ring_attention` (causal zigzag, seq 2),
`make_ulysses_attention` (seq 2) and `make_tp_attention` (data 2 x model 2)
on its 8-device virtual mesh, once each, and JAX's single-device
`flash_attn_func` for the other cases, as JAX's `tests/test_sharding.py`
holds its own. fp32 throughout: outputs within 2e-5, gradients within 3e-5
(5e-5 with dropout), the tolerances of JAX's `test_sharding.py`. Every
case runs forward + backward of sum(out * do) (+ sum(lse * dlse) where it
returns the lse).
"""
import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fa2_triton_tpu import flash_attn_func as jax_flash  # noqa: E402
from fa2_triton_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from fa2_triton_tpu.parallel import make_ring_attention as jax_ring  # noqa: E402
from fa2_triton_tpu.parallel import make_tp_attention as jax_tp  # noqa: E402
from fa2_triton_tpu.parallel import make_ulysses_attention as jax_ulysses  # noqa: E402
from fa2_triton_tpu_torch.parallel import spawn_ranks  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_ranks as tpr  # noqa: E402

S2 = {"seq": 2}
DROP = dict(dropout_p=0.2, dropout_seed=1234)
# name: (the port's case, its JAX reference: "mesh" = JAX's own parallel
# function on the virtual mesh, "single" = flash_attn_func on one device).
CASES = {
    "ring_causal_zigzag": (dict(kind="ring", mesh=S2, shape=(1, 512, 2, 2, 64), seed=0,
                                kw=dict(causal=True)), "mesh"),
    "ring_noncausal": (dict(kind="ring", mesh=S2, shape=(1, 256, 2, 2, 64), seed=1,
                            kw=dict(causal=False)), "single"),
    "ring_causal_contiguous": (dict(kind="ring", mesh=S2, shape=(1, 256, 2, 2, 64), seed=2,
                                    kw=dict(causal=True, zigzag=False)), "single"),
    "ring_window": (dict(kind="ring", mesh=S2, shape=(1, 512, 2, 2, 64), seed=3,
                         kw=dict(causal=True, window=(100, 0))), "single"),
    "ring_dropout_seed": (dict(kind="ring", mesh=S2, shape=(1, 512, 2, 2, 64), seed=4,
                               kw=dict(causal=True, **DROP)), "single"),
    "ring_lse_grads": (dict(kind="ring", mesh=S2, shape=(1, 512, 2, 2, 64), seed=5, lse=True,
                            kw=dict(causal=True)), "single"),
    # S / (2 x 2) = 192 rows: no lane-aligned zigzag chunks, so the causal
    # ring takes the contiguous layout (JAX l.506-508).
    "ring_zigzag_cannot_split": (dict(kind="ring", mesh=S2, shape=(1, 768, 2, 2, 64), seed=6,
                                      kw=dict(causal=True)), "single"),
    "ulysses": (dict(kind="ulysses", mesh=S2, shape=(1, 256, 4, 2, 64), seed=7,
                     kw=dict(causal=True)), "mesh"),
    "tp_attention": (dict(kind="tp", mesh={"data": 2, "model": 2}, shape=(2, 256, 4, 2, 64),
                          seed=8, kw=dict(causal=True)), "mesh"),
    "ring_gqa_model2_seq2": (dict(kind="ring", mesh={"model": 2, "seq": 2},
                                  shape=(1, 512, 4, 2, 64), seed=9, kw=dict(causal=True)), "single"),
}
WORLD = {name: (4 if name in ("tp_attention", "ring_gqa_model2_seq2") else 2) for name in CASES}
RNG_CASES = [dict(kind="ring", mesh=S2, shape=(1, 512, 2, 2, 64), seed=4, rng=r,
                  kw=dict(causal=True, dropout_p=0.2)) for r in (0, 1)]


def _port_worlds():
    """Every port case, the world of 2 and the world of 4 each spawned
    once: {name: result}, plus the two dropout_rng runs and the raise."""
    out = {}
    for world in (2, 4):
        names = [n for n in CASES if WORLD[n] == world]
        extra = RNG_CASES if world == 2 else []
        res = spawn_ranks(tpr.attention_cases_rank, world,
                          ([CASES[n][0] for n in names] + extra,), timeout_s=300)[0]
        out.update(zip(names, res))
        if world == 2:
            out["rng"] = res[len(names):]
    return out


def _jax_inputs(case):
    return [jnp.asarray(t.numpy()) for t in tpr.attention_inputs(*case["shape"], case["seed"])]


def _jax_reference(case, how):
    """out, lse, (dq, dk, dv) of the case from JAX, as numpy."""
    q, k, v, do, dlse = _jax_inputs(case)
    kw = dict(case["kw"])
    if how == "mesh":
        devs = jax.devices()
        if case["kind"] == "ring":
            fn = jax_ring(jax_mesh(seq=2, devices=devs[:2]), **kw)
        elif case["kind"] == "ulysses":
            fn = jax_ulysses(jax_mesh(seq=2, devices=devs[:2]), **kw)
        else:
            fn = jax_tp(jax_mesh(data=2, model=2, devices=devs[:4]), **kw)

        def run(q, k, v):
            out, vjp = jax.vjp(fn, q, k, v)
            return out, None, vjp(do)
    else:
        kw.pop("zigzag", None)
        if "window" in kw:
            kw["window_size"] = kw.pop("window")

        def run(q, k, v):
            (out, lse), vjp = jax.vjp(lambda *x: jax_flash(*x, return_lse=True, **kw), q, k, v)
            return out, lse, vjp((do, dlse if case.get("lse") else jnp.zeros_like(dlse)))
    out, lse, grads = jax.jit(run)(q, k, v)
    return (np.asarray(out), None if lse is None else np.asarray(lse),
            [np.asarray(g) for g in grads])


@pytest.fixture(scope="module")
def results():
    """(the port's results, JAX's references), the port's worlds running in
    a thread while JAX computes."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_worlds)
        refs = {name: _jax_reference(case, how) for name, (case, how) in CASES.items()}
        return port.result(), refs


@pytest.mark.parametrize("name", list(CASES))
def test_parallel_attention_matches_jax(results, name):
    port, refs = results
    got, (out, lse, grads) = port[name], refs[name]
    tol = 5e-5 if "dropout" in name else 3e-5
    assert np.abs(got["out"] - out).max() < 2e-5
    for n, g in zip(("dq", "dk", "dv"), grads):
        assert np.abs(got[n] - g).max() < tol, (n, np.abs(got[n] - g).max())
    if lse is not None and got["lse"] is not None:
        assert np.abs(got["lse"] - lse).max() < 2e-5


def test_ring_dropout_rng_generators_draw_different_masks(results):
    """Two CPU generators of other seeds draw other seeds (from the first
    rank, broadcast), so the masks, and the outputs, differ."""
    a, b = results[0]["rng"]
    assert np.abs(a["out"] - b["out"]).max() > 1e-3


def test_ring_dropout_without_a_seed_raises():
    """flash_attn_func's seed contract, before any collective: dropout_p > 0
    with neither dropout_seed nor dropout_rng raises."""
    from fa2_triton_tpu_torch.parallel.ring import shared_dropout_seed

    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        shared_dropout_seed(0.2, None, None)


def test_zigzag_permutation_round_trips_like_jax():
    from fa2_triton_tpu.parallel.ring import zigzag_permute as jax_zz
    from fa2_triton_tpu_torch.parallel.ring import zigzag_permute, zigzag_unpermute

    x = np.arange(2 * 16 * 3).reshape(2, 16, 3).astype(np.float32)
    for n in (1, 2, 4):
        got = zigzag_permute(torch.from_numpy(x), n)
        assert np.array_equal(got.numpy(), np.asarray(jax_zz(jnp.asarray(x), n)))
        assert torch.equal(zigzag_unpermute(got, n), torch.from_numpy(x))
