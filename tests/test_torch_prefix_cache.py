"""The port's prefix cache (`runtime/paged_cache.py`: `match_prefix`,
`attach`, `register_prefix`, the LRU of released registered pages) and the
paged Engine's prefix-cache mode against the JAX package's.

Allocator: the same script on a JAX and a port `PagedKVCache` leaves the
same free list, LRU order, hash maps, refcounts and tables, bit for bit,
and every match and `free_pages` reading along the way is equal. Engine
(`tests/torch_engine.py`'s tiny model; paged, page 128;
`tests/test_prefix_cache.py`'s cases): tokens
equal and log-probs within 1e-4, with every served token's top-1 margin
above 10x that tolerance, `prefix_cached_tokens` and the allocator state
equal to JAX's after the run, and the warm tokens equal to a cold engine's.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.runtime import Engine as JaxEngine
from fa2_triton_tpu.runtime import paged_cache as jpc

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.runtime import Engine  # noqa: E402
from fa2_triton_tpu_torch.runtime import paged_cache as tpc  # noqa: E402
from tests.torch_engine import (  # noqa: E402, F401 (models: a fixture)
    J_CFG, LP_TOL, T_CFG, ChoiceMargins, models,
)

P = 128


def _alloc_state(pc):
    return dict(free=list(pc._free), lru=list(pc._cached_free), hashes=dict(pc._hash_to_page),
                page_hash=dict(pc._page_hash), refs=np.asarray(pc._refs).tolist(),
                tables=np.asarray(pc._tables).tolist(),
                slot_pages=[list(p) for p in pc._slot_pages],
                freed=list(pc._slot_freed), free_pages=pc.free_pages)


# ------------------------------------------------------------- allocator --

def _cycle(pc, seen):
    """test_prefix_cache.py:test_match_register_release_cycle."""
    prompt = list(range(2 * P + 10))
    seen.append(pc.match_prefix(prompt))
    pc.ensure_capacity(0, len(prompt))
    pc.register_prefix(0, prompt)
    seen += [pc.match_prefix(prompt), pc.match_prefix(prompt[:2 * P]), pc.free_pages]
    pc.release(0)
    n, pages = pc.match_prefix(prompt)
    seen += [n, pc.free_pages]
    pc.attach(1, pages)
    seen.append(_alloc_state(pc))
    pc.release(1)


def _lru(pc, seen):
    """test_prefix_cache.py:test_lru_eviction_unregisters, then a refill."""
    prompt_a = [1] * (P + 1)
    pc.ensure_capacity(0, len(prompt_a))
    pc.register_prefix(0, prompt_a)
    pc.release(0)
    seen += [pc.match_prefix(prompt_a), pc.free_pages]
    pc.ensure_capacity(1, 3 * P)          # evicts A's page from the LRU
    seen += [pc.match_prefix(prompt_a), _alloc_state(pc)]
    try:
        pc.ensure_capacity(0, P)
        seen.append("allocated")
    except MemoryError:
        seen.append("MemoryError")
    pc.release(1)


def _shared(pc, seen):
    """test_prefix_cache.py:test_shared_page_refcounted_not_evictable, and
    a window release of a registered page (it joins the LRU)."""
    prompt = [7] * (P + 1)
    pc.ensure_capacity(0, len(prompt))
    pc.register_prefix(0, prompt)
    n, pages = pc.match_prefix(prompt)
    pc.attach(1, pages)
    seen.append(_alloc_state(pc))
    pc.release(0)
    pc.ensure_capacity(1, 2 * P)
    seen.append(_alloc_state(pc))
    pc.release_prefix(1, 1)               # the shared page, ref 1 -> 0: to the LRU
    pc.register_prefix(1, prompt + [3] * P)   # skips the released page
    seen += [_alloc_state(pc), pc.match_prefix(prompt + [3] * P + [1])]
    pc.release(1)


@pytest.mark.parametrize("script", [_cycle, _lru, _shared], ids=["cycle", "lru", "shared"])
def test_allocator_matches_jax_bitwise(script):
    kw = dict(n_layers=1, n_kv_heads=1, head_dim=128, page_size=P, n_pages=4, n_slots=2,
              max_seq=4 * P)
    jc = jpc.PagedKVCache(jpc.PagedCacheConfig(**kw))
    tc = tpc.PagedKVCache(tpc.PagedCacheConfig(**kw, compute_dtype=torch.float32), device="cpu")
    j_seen, t_seen = [], []
    script(jc, j_seen)
    script(tc, t_seen)
    assert t_seen == j_seen
    assert _alloc_state(tc) == _alloc_state(jc)
    assert tc.free_pages == 3 and not tc._refs.any()


def test_attach_needs_an_empty_slot():
    cfg = tpc.PagedCacheConfig(n_layers=1, n_kv_heads=1, head_dim=64, page_size=P, n_pages=4,
                               n_slots=2, max_seq=2 * P, compute_dtype=torch.float32)
    pc = tpc.PagedKVCache(cfg, device="cpu")
    pc.ensure_capacity(0, 10)
    with pytest.raises(ValueError, match="empty slot"):
        pc.attach(0, [2])


# ---------------------------------------------------------------- engine --

def _waves(engine, waves, new):
    """Serve each wave of prompts to completion, one after the other; `new`
    tokens per request, or a count per wave."""
    news = new if isinstance(new, (list, tuple)) else [new] * len(waves)
    reqs = []
    for wave, n in zip(waves, news):
        reqs += [engine.submit(p, n) for p in wave]
        engine.run()
        assert all(r.done and len(r.out_tokens) == n for r in reqs[-len(wave):])
    return reqs


def _engines_agree(models, monkeypatch, waves, new, qname=None, **kw):
    """The JAX and the port Engine in prefix-cache mode on the same waves:
    tokens, log-probs, stats and allocator state. Returns the port's engine
    and requests."""
    jp, tm = models
    kw = dict(dict(n_slots=2, max_seq=512, paged=True, page_size=P, prefix_cache=True), **kw)
    jq, tq = {None: (None, None), "int8": (jnp.int8, torch.int8)}[qname]
    j_engine = JaxEngine(jp, J_CFG, qdtype=jq, **kw)
    j_reqs = _waves(j_engine, waves, new)
    engine = Engine(tm, T_CFG, qdtype=tq, **kw)
    margins = ChoiceMargins(engine, monkeypatch)
    t_reqs = _waves(engine, waves, new)
    margins.check()
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.out_tokens == jr.out_tokens
        np.testing.assert_allclose(tr.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)
    for name in ("prefix_cached_tokens", "prefill_tokens", "decode_tokens", "decode_steps"):
        assert getattr(engine.stats, name) == getattr(j_engine.stats, name), name
    assert _alloc_state(engine.pcache) == _alloc_state(j_engine.pcache)
    assert engine.pcache.free_pages == engine.kv_cfg.n_pages - 1
    return engine, t_reqs, j_engine


def _cold(models, prompts, new, **kw):
    eng = Engine(models[1], T_CFG, **dict(dict(n_slots=2, max_seq=512, paged=True,
                                               page_size=P), **kw))
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run()
    return [r.out_tokens for r in reqs]


def _prompts(case):
    rng = np.random.RandomState({"repeat": 3, "shared_head": 4}[case])
    if case == "repeat":
        p = rng.randint(0, 128, size=200).tolist()
        return [p, p], 128
    head = rng.randint(0, 128, size=256).tolist()
    return [head + rng.randint(0, 128, size=n).tolist() for n in (30, 50)], 256


@pytest.mark.parametrize("case", ["repeat", "shared_head"])
def test_prefix_hit_matches_jax(models, monkeypatch, case):
    """Two requests admitted one at a time: the second attaches the first's
    registered full pages and prefills only its suffix over them."""
    prompts, cached = _prompts(case)
    engine, reqs, _ = _engines_agree(models, monkeypatch, [prompts], 4)
    assert engine.stats.prefix_cached_tokens == cached
    assert engine.stats.prefill_tokens == sum(map(len, prompts)) - cached
    assert [r.out_tokens for r in reqs] == _cold(models, prompts, 4)


def test_prefix_cache_survives_completion_and_multiturn_reuse(models, monkeypatch):
    """Pages of a finished request stay resident and serve a later one on a
    single-slot engine; a follow-up turn (prompt + the answer + new tokens)
    hits the generated tokens' full page too. (The prompt seed is 8, not
    tests/test_prefix_cache.py's 7: seed 7's 40 greedy steps hold a near
    tie, top-1 margin 6.8e-4, below the 1e-3 this file asks of a sound
    token check.)"""
    rng = np.random.RandomState(8)
    p1 = rng.randint(0, 128, size=100).tolist()
    jp, tm = models
    first = Engine(tm, T_CFG, n_slots=1, max_seq=512, paged=True, page_size=P)
    answer = first.submit(p1, 40)
    first.run()
    p2 = p1 + answer.out_tokens + rng.randint(0, 128, size=20).tolist()
    engine, reqs, _ = _engines_agree(models, monkeypatch, [[p1], [p2]], [40, 4], n_slots=1)
    assert reqs[0].out_tokens == answer.out_tokens
    # 100 prompt + 39 fed generated tokens = 139 rows of k/v: one full page.
    assert engine.stats.prefix_cached_tokens == P
    assert reqs[1].out_tokens == _cold(models, [p2], 4, n_slots=1)[0]


def test_prefix_cache_int8_pool_matches_jax(models, monkeypatch):
    """Shared pages carry int8 values and scales; the suffix prefill reads
    the dequantized prefix. The registered pages' stored values equal JAX's
    (first D columns) before log-probs are held to 1e-4."""
    rng = np.random.RandomState(6)
    prompt = rng.randint(0, 128, size=150).tolist()
    engine, _, j_engine = _engines_agree(models, monkeypatch, [[prompt, prompt]], 4, qname="int8")
    assert engine.stats.prefix_cached_tokens == P
    pages = sorted(engine.pcache._page_hash)
    assert pages
    for tp, jp_ in zip(engine.pcache.pools, j_engine.pcache.pools):
        for name in ("k", "v"):
            np.testing.assert_array_equal(tp[name][pages][..., :T_CFG.hd].numpy(),
                                          np.asarray(jp_[name])[pages][..., :T_CFG.hd])
            assert not tp[name][..., T_CFG.hd:].float().any()   # the kernels' zero padding


def test_lru_eviction_and_refcounts_match_jax(models, monkeypatch):
    """Four usable pages, one slot: A registers its first page; A again
    hits it; B's 512-row bucket takes all four pages, evicting A's from the
    LRU; A a third time misses. Refcounts, LRU and hashes equal JAX's."""
    rng = np.random.RandomState(12)
    a = rng.randint(0, 128, size=200).tolist()
    b = rng.randint(0, 128, size=300).tolist()
    engine, reqs, _ = _engines_agree(models, monkeypatch, [[a], [a], [b], [a]], 4, n_slots=1,
                                     n_pages=5)
    assert engine.stats.prefix_cached_tokens == P
    assert reqs[0].out_tokens == reqs[1].out_tokens == reqs[3].out_tokens
    assert not engine.pcache._refs.any()


def test_chunked_prefill_composes_with_prefix_cache(models, monkeypatch):
    """A repeated 300-token prompt under chunked + prefix-cache serving: the
    second request's chunk cursor starts past the two cached pages."""
    prompt = np.random.RandomState(9).randint(0, 128, size=300).tolist()
    engine, reqs, _ = _engines_agree(models, monkeypatch, [[prompt], [prompt]], 4, n_slots=1,
                                     prefill_chunk=P)
    assert engine.stats.prefix_cached_tokens == 2 * P
    assert reqs[0].out_tokens == reqs[1].out_tokens
