"""The host table of the packed kernels' 16-bit versions (`ops/varlen.py`):
the 64-row tiles heaviest first (`_tile_order`), the work behind that order
(`_tile_work`) against the element mask of each work-list entry, and what
the forward, dq and dk/dv launches hand the kernels, read through a
stand-in entry point (no build, no GPU), including the forward's q-major
table that `_VarlenCore` hands the backward's dq launch. Small layouts, CPU
only."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import varlen  # noqa: E402


def _layout(lens, blocks):
    align = max(blocks)
    starts = [0]
    for n in lens[:-1]:
        starts.append(starts[-1] + -(-max(n, 1) // align) * align)
    return starts, starts[-1] + -(-max(lens[-1], 1) // align) * align


# (starts, T, q lens, kv lens, (block_q, block_kv), block mask per segment or None)
CASES = {
    "ragged": (*_layout((300, 1, 128, 77), (128, 128)), (300, 1, 128, 77), (300, 1, 128, 77),
               (128, 128), None),
    "block_kv_64": (*_layout((300, 1, 128, 77), (128, 64)), (300, 1, 128, 77), (300, 1, 128, 77),
                    (128, 64), None),
    "block_q_64": (*_layout((200, 77), (64, 128)), (200, 77), (200, 77), (64, 128), None),
    "q_len_ne_kv_len": ([0, 512, 768], 1280, (300, 1, 200), (200, 64, 449), (128, 256), None),
    "heavy_tail": (*_layout((1000,) + (64,) * 6, (64, 64)), (1000,) + (64,) * 6,
                   (1000,) + (64,) * 6, (64, 64), None),
    "block_sparse": ([0, 512], 1024, (512, 400), (512, 400), (128, 128),
                     np.random.RandomState(0).rand(4, 4) < 0.6),
}


def _table(case, causal, kv_major, group):
    starts, T, qlens, kvlens, (bq, bkv), mask = CASES[case]
    keep = None if mask is None else varlen._mask_keep_fn(varlen.encode_block_mask(mask))
    segs = varlen._segments(starts, T, qlens, kvlens, bq, bkv)
    work = varlen._build_schedule(starts, [s[1] for s in segs], qlens, kvlens, bq, bkv, causal,
                                  kv_major=kv_major, group=group, keep_block=keep)
    return segs, work, T, bq, bkv, keep


def _brute_work(segs, work, T, bq, bkv, causal, kv_major):
    """Per 64-row tile, from each entry's own lengths element by element: a
    q tile sums, over its user block's entries, 1 + the last key of the kv
    block that a live row of the tile keeps; a kv tile the q rows of the
    entry's q block that keep a live column of the tile."""
    out = np.zeros(T // 64, np.int64)
    for tile in range(T // 64):
        t0 = tile * 64
        a = next(s[0] for s in segs if s[0] <= t0 < s[0] + s[1])
        ub = t0 // (bkv if kv_major else bq)
        for w in work[work[:, 1 if kv_major else 0] == ub]:
            q_lo, kv_lo, qlen, kvlen = (int(x) for x in w[2:6])
            if kv_major:
                rows, cols = q_lo + np.arange(bq), t0 - a + np.arange(64)
            else:
                rows, cols = t0 - a + np.arange(64), kv_lo + np.arange(bkv)
            keep = (rows[:, None] < qlen) & (cols[None] < kvlen)
            if causal:
                keep &= cols[None] <= rows[:, None] + (kvlen - qlen)
            if kv_major:
                out[tile] += int(keep.any(1).sum())
            else:
                kept = np.flatnonzero(keep.any(0))
                out[tile] += int(kept[-1]) + 1 if kept.size else 0
    return out


@pytest.mark.parametrize("kv_major", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_work_agrees_with_the_entries(case, causal, kv_major):
    segs, work, T, bq, bkv, _ = _table(case, causal, kv_major, 2 if kv_major else 1)
    want = _brute_work(segs, work, T, bq, bkv, causal, kv_major)
    np.testing.assert_array_equal(varlen._tile_work(work, T, bq, bkv, causal, kv_major), want)


@pytest.mark.parametrize("kv_major", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_order_is_every_tile_heaviest_first(case, causal, kv_major):
    """A permutation of the tiles, sorted by work with ties by index, and
    the same on two calls."""
    _, work, T, bq, bkv, _ = _table(case, causal, kv_major, 1)
    order = varlen._tile_order(work, T, bq, bkv, causal, kv_major)
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(T // 64))
    load = varlen._tile_work(work, T, bq, bkv, causal, kv_major)
    key = sorted(range(T // 64), key=lambda i: (-load[i], i))
    np.testing.assert_array_equal(order, key)
    np.testing.assert_array_equal(varlen._tile_order(work, T, bq, bkv, causal, kv_major), order)


def test_heavy_tail_starts_with_the_long_document():
    """One long causal document among short ones: its tiles lead both
    orders, longest loops first."""
    _, work, T, bq, bkv, _ = _table("heavy_tail", True, False, 1)
    order = varlen._tile_order(work, T, bq, bkv, True)
    n_long = -(-1000 // 64)
    assert sorted(order[:n_long]) == list(range(n_long))
    assert list(order[:3]) == [n_long - 1, n_long - 2, n_long - 3]
    _, work, T, bq, bkv, _ = _table("heavy_tail", True, True, 1)
    assert list(varlen._tile_order(work, T, bq, bkv, True, kv_major=True)[:3]) == [0, 1, 2]


@pytest.mark.parametrize("case", ["ragged", "block_kv_64", "block_sparse"])
def test_backward_launches_hand_the_kernels_their_tables(monkeypatch, case):
    """dq (1) then dk/dv (2): each call carries its work list (q-major;
    kv-major over the GQA group), the CSR row pointer over it and the tile
    order, as `_build_schedule` and `_tile_order` give them."""
    starts, T, qlens, kvlens, (bq, bkv), mask = CASES[case]
    causal, Hq, Hkv, D = True, 4, 2, 64
    keep = None if mask is None else varlen._mask_keep_fn(varlen.encode_block_mask(mask))
    segs = varlen._segments(starts, T, qlens, kvlens, bq, bkv)
    read = lambda ptr, n: np.ctypeslib.as_array((ctypes.c_int * n).from_address(ptr)).copy()  # noqa: E731
    seen = []

    def entry(which, *args):
        work_p, rowptr_p, order_p = args[15:18]
        kv_major = which == 2
        want = varlen._build_schedule(starts, [s[1] for s in segs], qlens, kvlens, bq, bkv, causal,
                                      kv_major=kv_major, group=Hq // Hkv if kv_major else 1,
                                      keep_block=keep)
        n_blocks = T // (bkv if kv_major else bq)
        work = read(work_p, want.size).reshape(-1, 8)
        rowptr = read(rowptr_p, n_blocks + 1)
        np.testing.assert_array_equal(work, want)
        np.testing.assert_array_equal(
            rowptr, np.searchsorted(want[:, 1 if kv_major else 0], np.arange(n_blocks + 1)))
        np.testing.assert_array_equal(read(order_p, T // 64),
                                      varlen._tile_order(want, T, bq, bkv, causal, kv_major))
        seen.append(which)
        return 0

    monkeypatch.setattr(varlen, "_entry", lambda: entry)
    monkeypatch.setattr(varlen._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(varlen, "LAUNCHES", dict.fromkeys(varlen.LAUNCHES, 0))
    x = lambda h: torch.zeros(1, T, h, D, dtype=torch.bfloat16).transpose(1, 2)  # noqa: E731
    q, k, v, do, dq, dk, dv = x(Hq), x(Hkv), x(Hkv), x(Hq), x(Hq), x(Hkv), x(Hkv)
    lse = torch.zeros(1, Hq, T)
    varlen._backward_launches(q, k, v, do, lse, lse, dq, dk, dv, segs, causal=causal,
                              softmax_scale=0.125, block_q=bq, block_kv=bkv, keep_block=keep,
                              drop=varlen.dropout_c_args(0.0, 0))
    assert seen == [1, 2]
    assert varlen.LAUNCHES == {"varlen_fwd": 0, "varlen_dq": 1, "varlen_dkdv": 1}


def _read(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_int * n).from_address(ptr)).copy()


def _tables_of(args, T, n_blocks):
    """(work, rowptr, order) of a stand-in launch's arguments."""
    work_p, rowptr_p, order_p = args[15:18]
    rowptr = _read(rowptr_p, n_blocks + 1)
    return _read(work_p, 8 * int(rowptr[-1])).reshape(-1, 8), rowptr, _read(order_p, T // 64)


def _stand_in(monkeypatch, entry):
    monkeypatch.setattr(varlen, "_entry", lambda: entry)
    monkeypatch.setattr(varlen._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(varlen, "LAUNCHES", dict.fromkeys(varlen.LAUNCHES, 0))


def _q_major(case, causal):
    """The q-major work list, row pointer and tile order of a case, built
    afresh."""
    starts, T, qlens, kvlens, (bq, bkv), mask = CASES[case]
    keep = None if mask is None else varlen._mask_keep_fn(varlen.encode_block_mask(mask))
    segs = varlen._segments(starts, T, qlens, kvlens, bq, bkv)
    work = varlen._build_schedule(starts, [s[1] for s in segs], qlens, kvlens, bq, bkv, causal,
                                  keep_block=keep)
    return (work, np.searchsorted(work[:, 0], np.arange(T // bq + 1)),
            varlen._tile_order(work, T, bq, bkv, causal))


@pytest.mark.parametrize("case", ["ragged", "block_kv_64", "block_sparse"])
def test_forward_launch_hands_the_kernel_its_table(monkeypatch, case):
    """The forward (0) carries the q-major work list, the CSR row pointer
    over it and the tiles heaviest first by `_tile_order(kv_major=False)`,
    and returns that table (tensor and addresses) for dq."""
    starts, T, qlens, kvlens, (bq, bkv), mask = CASES[case]
    causal, Hq, Hkv, D = True, 4, 2, 64
    keep = None if mask is None else varlen._mask_keep_fn(varlen.encode_block_mask(mask))
    segs = varlen._segments(starts, T, qlens, kvlens, bq, bkv)
    seen = []

    def entry(which, *args):
        seen.append((which, args[15:18], _tables_of(args, T, T // bq)))
        return 0

    _stand_in(monkeypatch, entry)
    x = lambda h: torch.zeros(1, T, h, D, dtype=torch.bfloat16).transpose(1, 2)  # noqa: E731
    q, k, v, o = x(Hq), x(Hkv), x(Hkv), x(Hq)
    lse = torch.zeros(1, Hq, T)
    table, ptrs = varlen._forward_launch(q, k, v, o, lse, segs, causal=causal, softmax_scale=0.125,
                                         block_q=bq, block_kv=bkv, keep_block=keep,
                                         drop=varlen.dropout_c_args(0.0, 0))
    assert [w for w, _, _ in seen] == [0]
    assert seen[0][1] == ptrs and ptrs[0] == table.data_ptr()
    for got, want in zip(seen[0][2], _q_major(case, causal)):
        np.testing.assert_array_equal(got, want)
    assert varlen.LAUNCHES == {"varlen_fwd": 1, "varlen_dq": 0, "varlen_dkdv": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["ragged", "block_kv_64", "block_sparse"])
def test_varlen_core_hands_dq_the_forwards_table(monkeypatch, case, dtype):
    """Through `_VarlenCore` (forward, then backward on the kernels' path):
    dq (1) runs on the forward's (0) table at the same addresses, bitwise
    equal to a fresh build, so `_build_schedule` runs twice (q-major, then
    kv-major for dk/dv (2)), not three times."""
    starts, T, qlens, kvlens, (bq, bkv), mask = CASES[case]
    causal, Hq, Hkv, D = True, 4, 2, 64
    enc = None if mask is None else varlen.encode_block_mask(mask)
    seen, builds = [], []

    def entry(which, *args):
        seen.append((which, args[15:18], _tables_of(args, T, T // (bkv if which == 2 else bq))))
        return 0

    build = varlen._build_schedule

    def counted(*a, **kw):
        builds.append(kw.get("kv_major", False))
        return build(*a, **kw)

    _stand_in(monkeypatch, entry)
    monkeypatch.setattr(varlen, "_uses_kernels", lambda q: True)
    monkeypatch.setattr(varlen, "_build_schedule", counted)
    x = lambda h: torch.zeros(1, T, h, D, dtype=dtype).transpose(1, 2).requires_grad_()  # noqa: E731
    q, k, v = x(Hq), x(Hkv), x(Hkv)
    meta = (tuple(starts), tuple(qlens), tuple(kvlens), causal, 0.125, bq, bkv, 0.0, 0, enc)
    o, _ = varlen._VarlenCore.apply(q, k, v, meta)
    o.backward(torch.zeros_like(o))
    assert [w for w, _, _ in seen] == [0, 1, 2]
    assert builds == [False, True]
    assert seen[1][1] == seen[0][1]
    for fwd, dq, want in zip(seen[0][2], seen[1][2], _q_major(case, causal)):
        np.testing.assert_array_equal(fwd, want)
        np.testing.assert_array_equal(dq, want)
    assert varlen.LAUNCHES == {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}
