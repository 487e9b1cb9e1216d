"""Chunked prefill in the port (`models/llama.py:chunk_prefill_step`,
`paged_chunk_prefill_step`, the Engine's `prefill_chunk`) against the JAX
package's.

Model level: two chunks through JAX's `chunk_prefill_step` and the port's
(`tests/torch_engine.py`'s tiny model), logits within 1e-4 and the
cache rows written: fp32 values to 1e-5, int8 values within one step (equal
on all but 0.1 %: a value on a rounding boundary may flip, ROADMAP.md
queue C) and scales to fp32 noise, over a plain, an int8 and a sliding-window config. The paged
form equals the contiguous one bit for bit on the CPU and writes no row
below cache_len. Engine level (`tests/test_serving.py` and
`tests/test_prefix_cache.py`'s chunked cases): tokens equal to JAX's and
log-probs within 1e-4, with every served token's top-1 margin above 10x
that tolerance.

The port writes only the chunk's true rows. JAX writes the whole padded
chunk, and where cache_len + C passes the cache XLA clamps the write and
the chunk lands over earlier rows (ROADMAP.md queue C): a 300-token prompt
in chunks of 256 at max_seq 384 must give the unchunked tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.runtime import Engine as JaxEngine
from fa2_triton_tpu.runtime import kv_cache as jkv

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402
from fa2_triton_tpu_torch.runtime import kv_cache as tkv  # noqa: E402
from fa2_triton_tpu_torch.runtime import paged_cache as tpc  # noqa: E402
from tests.torch_engine import (  # noqa: E402, F401 (models: a fixture)
    J_CFG, LP_TOL, T_CFG, ChoiceMargins, models,
)


# ----------------------------------------------------------- model level --

def _chunks(C=128, lens=(128, 77), seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for n in lens:
        tok = np.zeros((1, C), np.int32)
        tok[0, :n] = rng.randint(0, 128, size=n)
        out.append((tok, n))
    return out


@pytest.mark.parametrize("case", ["plain", "int8", "window"])
@torch.inference_mode()
def test_chunk_prefill_step_matches_jax(models, case):
    """Chunks of 128 and 77 true tokens (C 128) at cache_len 0 and 128 into
    slot 1 of a 2-slot cache of 256 rows."""
    jp, tm = models
    jcfg, tcfg = J_CFG, T_CFG
    if case == "window":
        jcfg, tcfg = (dataclasses.replace(c, sliding_window=48) for c in (J_CFG, T_CFG))
    jq, tq = (jnp.int8, torch.int8) if case == "int8" else (None, None)
    ckw = dict(n_layers=2, n_kv_heads=2, head_dim=16, max_seq=256, n_slots=2)
    jkc = jkv.KVCacheConfig(**ckw, qdtype=jq, compute_dtype=jnp.float32, block_kv=256)
    tkc = tkv.KVCacheConfig(**ckw, qdtype=tq, compute_dtype=torch.float32)
    j_caches = [{n: t[1:2] for n, t in c.items()} for c in jkv.init_cache(jkc)]
    t_caches = tkv.init_cache(tkc, device="cpu")
    cache_len = 0
    for tok, n in _chunks():
        j_logits, j_caches = jl.chunk_prefill_step(
            jp, jnp.asarray(tok), jnp.asarray([n], jnp.int32), jnp.asarray([cache_len], jnp.int32),
            jcfg, j_caches, jkc)
        t_logits = tl.chunk_prefill_step(tm if case != "window" else _windowed(jp, tcfg),
                                         torch.from_numpy(tok).long(), n, cache_len, t_caches, tkc,
                                         slot=1)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=LP_TOL)
        cache_len += n
    assert not t_caches[0]["k"][0].float().any()      # slot 0 untouched
    for jc, tc in zip(j_caches, t_caches):
        for name in ("k", "v"):
            # D 16 padded with zeros: to the kernels' 64 here, to 128 in JAX.
            assert tc[name].shape[-1] == 64 and not tc[name][..., 16:].float().any()
            t, j = tc[name][1, :, :cache_len, :16], np.asarray(jc[name])[0, :, :cache_len, :16]
            if case == "int8":
                # ROADMAP.md queue C "int8 rounding": a k/v whose fp32 value
                # sits on a rounding boundary may store one step apart.
                d = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, ((d > 0).sum(), d.size)
                np.testing.assert_allclose(tc[name + "_scale"][1, ..., :cache_len].numpy(),
                                           np.asarray(jc[name + "_scale"])[0, ..., :cache_len],
                                           rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
            assert not tc[name][1, :, cache_len:].float().any()   # no padded row written


def _windowed(jp, tcfg):
    return llama_from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("qname", [None, "int8"])
@torch.inference_mode()
def test_paged_chunk_equals_contiguous_and_spares_shared_rows(models, qname):
    """The same two chunks through `paged_chunk_prefill_step` over a
    shuffled table of page 128: logits equal the contiguous form's bit for
    bit, every row equals the contiguous cache's, and the first page, held
    as a shared prefix page, is not written by the second chunk."""
    _, tm = models
    tq = torch.int8 if qname else None
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=16, n_slots=2, qdtype=tq,
              compute_dtype=torch.float32)
    kcfg = tkv.KVCacheConfig(max_seq=256, **kw)
    t_caches = tkv.init_cache(kcfg, device="cpu")
    pcfg = tpc.PagedCacheConfig(page_size=128, n_pages=6, max_seq=256, **kw)
    pc = tpc.PagedKVCache(pcfg, device="cpu")
    pc._tables[1, :2] = [4, 2]
    cache_len = 0
    for i, (tok, n) in enumerate(_chunks()):
        tok = torch.from_numpy(tok).long()
        if i == 1:
            shared = [{name: t[4].clone() for name, t in pool.items()} for pool in pc.pools]
        c = tl.chunk_prefill_step(tm, tok, n, cache_len, t_caches, kcfg, slot=1)
        p = tl.paged_chunk_prefill_step(tm, tok, n, cache_len, pc.pools, pc.tables_device(), 1,
                                        pcfg)
        torch.testing.assert_close(p, c, rtol=0, atol=0)
        cache_len += n
    for pool, old in zip(pc.pools, shared):
        for name, t in old.items():
            torch.testing.assert_close(pool[name][4], t, rtol=0, atol=0)
    for pool, cache in zip(pc.pools, t_caches):
        for name in pool:
            # Logical pages 0, 1 of slot 1 back to back: rows, or scale columns.
            seq = -1 if "scale" in name else -2
            rows = torch.cat([pool[name][4], pool[name][2]], dim=seq).narrow(seq, 0, cache_len)
            torch.testing.assert_close(rows, cache[name][1].narrow(seq, 0, cache_len), rtol=0, atol=0)


@torch.inference_mode()
def test_chunk_past_the_cache_raises(models):
    _, tm = models
    kc = tkv.KVCacheConfig(n_layers=2, n_kv_heads=2, head_dim=16, max_seq=256, n_slots=1,
                           compute_dtype=torch.float32)
    caches = tkv.init_cache(kc, device="cpu")
    tok = torch.zeros((1, 128), dtype=torch.long)
    with pytest.raises(ValueError, match="pass the cache"):
        tl.chunk_prefill_step(tm, tok, 100, 200, caches, kc)
    with pytest.raises(ValueError, match="chunk_len"):
        tl.chunk_prefill_step(tm, tok, 129, 0, caches, kc)
    for bad in (dict(prefill_chunk=100), dict(prefix_cache=True)):
        with pytest.raises(ValueError):
            Engine(tm, T_CFG, n_slots=1, max_seq=256, **bad)


# ---------------------------------------------------------- engine level --

def _run(engine, prompts, new):
    reqs = [engine.submit(p, n) for p, n in zip(prompts, new)]
    engine.run()
    assert all(r.done and len(r.out_tokens) == n for r, n in zip(reqs, new))
    return reqs


def _agree(t_reqs, j_reqs):
    for tr, jr in zip(t_reqs, j_reqs):
        assert tr.out_tokens == jr.out_tokens
        np.testing.assert_allclose(tr.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)


CASES = {
    # tests/test_serving.py:175: 200 / 5 / 150 tokens, 2 slots, max_seq 256.
    "contiguous": (3, (200, 5, 150), (6, 6, 6), dict(n_slots=2, max_seq=256)),
    # tests/test_prefix_cache.py:184: 300 and 6 tokens, paged at page 128.
    "paged": (8, (300, 6), (4, 12), dict(n_slots=2, max_seq=512, paged=True, page_size=128)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_engine_matches_jax(models, monkeypatch, case):
    """Chunks of 128 interleaved with decode: tokens equal JAX's chunked
    engine and the port's unchunked one; every chunk is a prefill
    dispatch."""
    jp, tm = models
    seed, lens, new, kw = CASES[case]
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in lens]
    j_reqs = _run(JaxEngine(jp, J_CFG, prefill_chunk=128, **kw), prompts, new)
    engine = Engine(tm, T_CFG, prefill_chunk=128, **kw)
    margins = ChoiceMargins(engine, monkeypatch)
    t_reqs = _run(engine, prompts, new)
    margins.check()
    _agree(t_reqs, j_reqs)
    long_chunks = sum(-(-n // 128) for n in lens if n > 128)
    short = sum(1 for n in lens if n <= 128)
    assert engine.stats.prefill_dispatches == long_chunks + short
    assert engine.stats.prefill_tokens == sum(lens)
    plain = _run(Engine(tm, T_CFG, **kw), prompts, new)
    assert [r.out_tokens for r in plain] == [r.out_tokens for r in t_reqs]
    if kw.get("paged"):
        assert engine.pcache.free_pages == engine.kv_cfg.n_pages - 1


def test_chunked_prefill_interleaves_decode(models):
    """tests/test_serving.py:192 on the port: while a long prompt prefills
    chunk by chunk, the other slot decodes every step; the final chunk's
    token and the same step's decode both land."""
    _, tm = models
    rng = np.random.RandomState(4)
    eng = Engine(tm, T_CFG, n_slots=2, max_seq=256, prefill_chunk=128)
    short = eng.submit(rng.randint(0, 128, size=5).tolist(), 20)
    eng.step()
    n_before = len(short.out_tokens)
    assert n_before >= 1
    long_req = eng.submit(rng.randint(0, 128, size=250).tolist(), 4)
    eng.step()          # long: chunk 1 of 2; short: one decode step
    assert eng._prefilling == {1: 128} and not long_req.out_tokens
    assert eng.lens_np[1] == 255          # the parked decode row
    assert len(short.out_tokens) == n_before + 1
    eng.step()          # long: final chunk -> first token, then a decode
    assert not eng._prefilling and len(long_req.out_tokens) == 2
    assert len(short.out_tokens) == n_before + 2
    eng.run()
    assert long_req.done and short.done


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunk_overrunning_the_cache_keeps_earlier_rows(models, monkeypatch, paged):
    """A 300-token prompt in chunks of 256 at max_seq 384: the second chunk
    starts at 256, and 256 + 256 passes the 384 rows. The port writes its 44
    true rows, so its tokens equal the unchunked engine's at max_seq 512,
    the JAX package's included (JAX's chunked engine here gives [34, 27, 34,
    27, 34, 27]: its padded write is clamped back over earlier rows)."""
    jp, tm = models
    prompt = np.random.RandomState(3).randint(0, 128, size=300).tolist()
    kw = dict(n_slots=1, paged=paged, **(dict(page_size=128) if paged else {}))
    assert 256 + 256 > 384 >= len(prompt)
    j_reqs = _run(JaxEngine(jp, J_CFG, max_seq=512), [prompt], [6])
    engine = Engine(tm, T_CFG, max_seq=384, prefill_chunk=256, **kw)
    margins = ChoiceMargins(engine, monkeypatch)
    t_reqs = _run(engine, [prompt], [6])
    assert engine.stats.prefill_dispatches == 2
    margins.check()
    _agree(t_reqs, j_reqs)
    assert t_reqs[0].out_tokens != [34, 27, 34, 27, 34, 27]
    whole = _run(Engine(tm, T_CFG, max_seq=512, **kw), [prompt], [6])
    assert whole[0].out_tokens == t_reqs[0].out_tokens
