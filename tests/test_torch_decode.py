"""The port's `decode_attention` (plain path on the CPU) against the JAX
`decode_attention` (Pallas `_decode_kernel_noquant` / `_decode_kernel` in
interpret mode): one query token per slot over a contiguous cache with
ragged lengths, including 1, stored in fp32 or quantized (int8 / fp8 with
the same stored values and scales on both sides). Max abs <= 1e-5: fp32 on
both sides. `quantize_tensor` is bitwise equal to JAX's."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.ops import decode as jdec
from fa2_triton_tpu.ops import quant as jquant

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import decode as tdec  # noqa: E402
from fa2_triton_tpu_torch.ops import quant as tquant  # noqa: E402

QDTYPES = [(jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]

TOL = 1e-5
KV_LENS = np.array([1, 5, 130, 256], np.int32)


def _inputs(seed, Hq=4, Hkv=2, D=128, S_max=256):
    rng = np.random.RandomState(seed)
    B = len(KV_LENS)
    q = rng.normal(0, 0.5, (B, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, Hkv, S_max, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, Hkv, S_max, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kw", [
    dict(), dict(window_left=7), dict(softcap=3.0), dict(window_left=100, softcap=2.0),
    dict(softmax_scale=0.05),
])
def test_decode_matches_jax(kw):
    q, k, v = _inputs(seed=len(kw))
    j = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(KV_LENS), **kw)
    t = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(KV_LENS), **kw)
    assert t.shape == q.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


def test_decode_mqa_matches_jax():
    q, k, v = _inputs(seed=11, Hq=4, Hkv=1)
    j = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(KV_LENS))
    t = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(KV_LENS))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


def test_decode_ignores_garbage_past_kv_len():
    """Rows at or past kv_len never reach the output, even NaN ones."""
    q, k, v = _inputs(seed=12)
    base = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(KV_LENS))
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(KV_LENS):
        k2[b, :, n:] = np.nan
        v2[b, :, n:] = np.nan
    out = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2),
                                torch.from_numpy(KV_LENS))
    torch.testing.assert_close(out, base, rtol=0, atol=0)


def _bits(x) -> np.ndarray:
    """A numpy or torch int8 / fp8 array as its int8 bit pattern."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int8).numpy()
    return np.asarray(x).view(np.int8)


@pytest.mark.parametrize("qd", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("D", [32, 128])
def test_quantize_tensor_matches_jax_bitwise(qd, D):
    """Values (by bit pattern) and scales equal JAX's, an all-zero row and
    rows of very different magnitude included."""
    rng = np.random.RandomState(D)
    x = (rng.normal(0, 1, (2, 3, 40, D)) * rng.uniform(1e-3, 1e3, (2, 3, 40, 1))).astype(np.float32)
    x[1, 2, 5] = 0.0
    jv, js = jquant.quantize_tensor(jnp.asarray(x), qd[0])
    tv, ts = tquant.quantize_tensor(torch.from_numpy(x), qd[1])
    assert tv.dtype == qd[1] and ts.dtype == torch.float32 and ts.shape == (2, 3, 40, 1)
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_tensor(tv, ts).numpy(),
        np.asarray(jquant.dequantize_tensor(jv, js)))


def _quantized(k, v, qd):
    """Quantize [B, Hkv, S, D] caches on the JAX side; the scales go to the
    kernels' [B, Hkv, 1, S] layout. Returns the JAX and the torch operands."""
    (kq, ks), (vq, vs) = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), qd[0])
    ks, vs = jnp.swapaxes(ks, 2, 3), jnp.swapaxes(vs, 2, 3)
    as_torch = lambda a: torch.from_numpy(_bits(a).copy()).view(qd[1])
    t = (as_torch(kq), as_torch(vq), torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)))
    return (kq, vq, ks, vs), t


@pytest.mark.parametrize("qd", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("kw", [
    dict(), dict(window_left=7), dict(softcap=3.0), dict(window_left=100, softcap=2.0),
    dict(softmax_scale=0.05),
])
def test_quantized_decode_matches_jax(qd, kw):
    q, k, v = _inputs(seed=20 + len(kw))
    j_ops, t_ops = _quantized(k, v, qd)
    kq, vq, ks, vs = j_ops
    j = jdec.decode_attention(jnp.asarray(q), kq, vq, jnp.asarray(KV_LENS), ks, vs, **kw)
    t = tdec.decode_attention(torch.from_numpy(q), t_ops[0], t_ops[1], torch.from_numpy(KV_LENS),
                              t_ops[2], t_ops[3], **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


def test_fp8_cache_without_scales_raises():
    """The reference bitcasts an fp8 cache without scales to int8 and reads
    garbage (ROADMAP queue C); the port refuses it. No JAX output is pinned."""
    q, k, v = _inputs(seed=13)
    k8, v8 = (torch.from_numpy(x).to(torch.float8_e4m3fn) for x in (k, v))
    with pytest.raises(ValueError, match="queue C"):
        tdec.decode_attention(torch.from_numpy(q), k8, v8, torch.from_numpy(KV_LENS))
    with pytest.raises(ValueError, match="queue C"):
        tdec.decode_attention(torch.from_numpy(q), k8, v8, torch.from_numpy(KV_LENS),
                              torch.ones(len(KV_LENS), 2, 1, 256))


def test_scale_layout_rules_raise():
    q, k, v = _inputs(seed=14)
    _, (kq, vq, ks, vs) = _quantized(k, v, QDTYPES[0])
    qt, lens = torch.from_numpy(q), torch.from_numpy(KV_LENS)
    bad = {
        "fp32": (ks.double(), vs),
        "contiguous": (torch.stack([ks, ks], -1)[..., 0], vs),
        "\\[4, 2, 1, 256\\]": (ks.transpose(-1, -2).contiguous(), vs),   # [B, Hkv, S, 1]
    }
    for match, (a, b) in bad.items():
        with pytest.raises(ValueError, match=match):
            tdec.decode_attention(qt, kq, vq, lens, a, b)
    with pytest.raises(ValueError, match="only int8"):
        tdec.decode_attention(qt, torch.from_numpy(k), torch.from_numpy(v), lens, ks, vs)


# The CUDA kernel's split-KV plan (csrc/decode.cuh): chunks of CHUNK logical
# rows on a grid sized from the cap alone; a chunk's live rows are
# [max(first, c CHUNK), min(kv_len, (c + 1) CHUNK)).

def _chunk_rows(kv_len, cap, window_left):
    """{chunk index: (lo, hi)} of the chunks holding a row of [first, kv_len)."""
    chunk = tdec.CHUNK
    kv_len = min(max(kv_len, 0), cap)
    first = max(0, kv_len - 1 - window_left) if window_left >= 0 else 0
    out = {}
    for c in range(tdec.chunk_count(cap)):
        lo, hi = max(first, c * chunk), min(kv_len, (c + 1) * chunk)
        if lo < hi:
            out[c] = (lo, hi)
    return first, kv_len, out


def test_chunk_mirrors_the_kernel():
    """ops/decode.py's CHUNK is the kernel's constexpr CHUNK, a multiple of
    its 128-row page run (the page-size multiple)."""
    src = (Path(tdec.__file__).parents[1] / "csrc" / "decode.cuh").read_text()
    run = int(re.search(r"constexpr int RUN = (\d+);", src)[1])
    chunk = int(re.search(r"constexpr int CHUNK = (\d+);", src)[1])
    assert chunk == tdec.CHUNK and run == tdec.PAGE_MULTIPLE and chunk % run == 0


@pytest.mark.parametrize("page", [None, 128, 512])
def test_split_kv_plan_covers_each_slots_rows_once(page):
    """Every cap (S_max, or max_pages x page), length and window: the live
    chunks are consecutive from first // CHUNK, inside the grid, their row
    ranges tile [first, kv_len) exactly, and `live_chunks` counts them (0
    for no key). A chunk's table holds its 128-row runs, each in one page. The grid and
    the scratch depend on shapes alone."""
    chunk = tdec.CHUNK
    caps = (1, 100, 128, 300, 4096, 4096 + 3 * 128) if page is None else \
        tuple(m * page for m in (1, 3, 8, 33))
    for cap in caps:
        assert tdec.chunk_count(cap) == max(1, -(-cap // chunk))
        assert tdec.chunk_count(cap) * chunk >= cap
        for kv_len in (0, 1, chunk - 1, chunk, chunk + 1, cap - 1, cap, cap + 50):
            for wl in (-1, 0, 5, chunk, 3 * chunk + 7):
                first, n, rows = _chunk_rows(kv_len, cap, wl)
                assert tdec.live_chunks(kv_len, cap, wl) == len(rows)
                if not rows:
                    assert n <= first
                    continue
                assert list(rows) == list(range(first // chunk, first // chunk + len(rows)))
                assert max(rows) < tdec.chunk_count(cap)
                covered = [r for lo, hi in rows.values() for r in range(lo, hi)]
                assert covered == list(range(first, n))
                run = tdec.PAGE_MULTIPLE
                for lo, hi in rows.values():
                    # The kernel's run table of a chunk: runs lo // 128 .. (hi - 1) // 128,
                    # at most CHUNK / 128 of them, each inside one page.
                    assert (hi - 1) // run - lo // run + 1 <= chunk // run
                    if page is not None:
                        assert all(r * run // page == (r * run + run - 1) // page
                                   for r in range(lo // run, (hi - 1) // run + 1))
    assert tdec.partials_shape(8, 8, 16, 4, 128) == (8, 8, 16, 4, 130)


@pytest.mark.parametrize("first", [(64, 8), (64, 100), (10, 300)])
def test_split_kv_scratch_is_reused_per_stream(monkeypatch, first):
    """The wrapper's scratch (partials, zeroed counters) is kept per (device,
    stream): a call that fits reuses it, a larger one grows both without
    shrinking either, and another stream gets its own."""
    monkeypatch.setattr(tdec, "_SCRATCH", {})
    dev = torch.device("cpu")
    part, cnt = tdec._scratch(dev, 1, *first)
    assert part.dtype == torch.float32 and cnt.dtype == torch.int32
    assert part.numel() >= first[0] and cnt.numel() >= first[1] and not cnt.any()
    again = tdec._scratch(dev, 1, first[0] // 2, 1)
    assert again[0] is part and again[1] is cnt
    grown = tdec._scratch(dev, 1, 2 * part.numel(), cnt.numel() + 1)
    assert grown[0].numel() == 2 * part.numel() and grown[1].numel() == cnt.numel() + 1
    assert not grown[1].any()
    assert tdec._scratch(dev, 1, 1, 1)[0] is grown[0]
    other = tdec._scratch(dev, 2, *first)
    assert other[0] is not grown[0] and set(tdec._SCRATCH) == {(None, 1), (None, 2)}


@pytest.mark.parametrize("block_kv", [128, 4096])
def test_decode_block_kv_matches_jax(block_kv):
    """JAX's block_kv (the TPU's kv block) is taken; the result is JAX's
    at either value, and a non-positive block raises."""
    q, k, v = _inputs(seed=21)
    j = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(KV_LENS), block_kv=block_kv, window_left=40)
    t = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(KV_LENS), block_kv=block_kv, window_left=40)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="block_kv"):
        tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(KV_LENS), block_kv=0)
