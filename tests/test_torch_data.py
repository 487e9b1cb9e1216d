"""The port's data pipeline (`fa2_triton_tpu_torch/utils/data.py`) against
the JAX package's `utils/data.py`: `tests/test_data.py`'s four tests on the
port, then the two packages side by side. The loader's windows and the
corpus files must be equal bit for bit (integers; no tolerance)."""
import itertools

import numpy as np
import pytest

from fa2_triton_tpu.utils import data as jdata

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.utils import data as tdata  # noqa: E402
from fa2_triton_tpu_torch.utils.data import (  # noqa: E402
    TokenLoader, encode_corpus, open_corpus, prefetch_to_device)


def test_corpus_roundtrip(tmp_path):
    toks = np.arange(1000) % 50000
    path = str(tmp_path / "corpus.bin")
    encode_corpus(toks, path, vocab_size=50000)
    back = open_corpus(path, vocab_size=50000)
    np.testing.assert_array_equal(np.asarray(back), toks.astype(np.uint16))


def test_windows_tile_and_target_overlap():
    data = np.arange(1 + 4 * 8, dtype=np.uint16)  # exactly 4 windows of 8
    dl = TokenLoader(data, batch=2, seq_len=8, seed=0)
    assert dl.n_windows == 4 and dl.steps_per_epoch == 2
    seen = []
    for b in dl.epoch(0):
        assert b.shape == (2, 9) and b.dtype == np.int32
        for row in b:
            assert (np.diff(row) == 1).all()
            seen.append(row[0] // 8)
    assert sorted(seen) == [0, 1, 2, 3]


def test_epoch_shuffle_deterministic():
    data = np.arange(1 + 64 * 16, dtype=np.uint16)
    a = [b.copy() for b in TokenLoader(data, 4, 16, seed=7).epoch(3)]
    b = [b.copy() for b in TokenLoader(data, 4, 16, seed=7).epoch(3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = [b.copy() for b in TokenLoader(data, 4, 16, seed=7).epoch(4)]
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_prefetch_preserves_stream_on_the_device():
    data = np.arange(1 + 16 * 8, dtype=np.uint16)
    dl = TokenLoader(data, batch=4, seq_len=8, seed=1)
    host = [b.copy() for b in dl.epoch(0)]
    dev = list(prefetch_to_device(dl.epoch(0), size=2, device="cpu"))
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        assert isinstance(d, torch.Tensor) and d.dtype == torch.int32 and d.device.type == "cpu"
        np.testing.assert_array_equal(d.numpy(), h)


@pytest.mark.parametrize("seed", [0, 123456789])
def test_loader_batches_equal_jax_over_three_epochs(seed):
    data = np.random.RandomState(1).randint(0, 50000, size=1 + 37 * 12).astype(np.uint16)
    jl, tl = jdata.TokenLoader(data, 3, 12, seed=seed), TokenLoader(data, 3, 12, seed=seed)
    assert (tl.n_windows, tl.steps_per_epoch) == (jl.n_windows, jl.steps_per_epoch) == (37, 12)
    for e in range(3):
        got, want = list(tl.epoch(e)), list(jl.epoch(e))
        assert len(got) == len(want) == 12
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("start", [0, 5, 12, 29])
def test_stream_resumes_where_an_uninterrupted_iteration_is(start):
    """`stream(step)` gives JAX's uninterrupted iteration from that global
    step on, across epoch ends (12 steps an epoch)."""
    data = np.random.RandomState(2).randint(0, 50000, size=1 + 37 * 12).astype(np.uint16)
    want = list(itertools.islice(iter(jdata.TokenLoader(data, 3, 12, seed=4)), start, start + 15))
    got = list(itertools.islice(TokenLoader(data, 3, 12, seed=4).stream(start), 15))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vocab", [50000, 65536, 65537, 151936])
def test_corpus_files_are_byte_equal(tmp_path, vocab):
    toks = np.random.RandomState(3).randint(0, vocab, size=4097)
    jdata.encode_corpus(toks, str(tmp_path / "jax.bin"), vocab)
    encode_corpus(toks, str(tmp_path / "torch.bin"), vocab)
    assert (tmp_path / "jax.bin").read_bytes() == (tmp_path / "torch.bin").read_bytes()
    a, b = jdata.open_corpus(str(tmp_path / "torch.bin"), vocab), open_corpus(
        str(tmp_path / "jax.bin"), vocab)
    assert a.dtype == b.dtype == (np.uint16 if vocab <= 65536 else np.uint32)
    np.testing.assert_array_equal(a, b)


def test_prefetch_defaults_to_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = prefetch_to_device(iter([np.zeros((1, 3), np.int32)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(it)


def test_too_small_a_corpus_raises():
    with pytest.raises(ValueError, match="windows < batch"):
        tdata.TokenLoader(np.arange(10, dtype=np.uint16), batch=2, seq_len=8)
