"""The port's paged and quantized serving pieces against the JAX package:
`paged_decode_attention` (plain path on the CPU) against the JAX one
(Pallas `_decode_kernel_paged` / `_paged_noquant` in interpret mode), the
`PagedKVCache` allocator and pool, `write_kv` with `qdtype`, and the
`Engine`'s paged / quantized modes, preemption and sliding-window page
release.

Tolerances: paged decode <= 2e-5 in fp32 (the bound of JAX's
tests/test_paged_cache.py); allocator state, pools, quantized values and
scales bitwise (JAX pads D to 128 with zeros: its first D columns are
compared); Engine tokens equal and log-probs within 1e-4, with every
step's top-1 margin in the port's served logits above 10x that tolerance,
so equal tokens are a sound check and not a coin toss between near ties.
Quantized storage amplifies last-bit fp32 differences between the two
frameworks: a k value on a rounding boundary flips by one int8 step and
moves later log-probs by ~5e-4 (prompt seed 0 does that once). The engine
prompts are drawn from seed 1, whose stored int8 values equal JAX's bit for
bit; the int8 test asserts that before it holds log-probs to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_triton_tpu.models import llama as jl
from fa2_triton_tpu.ops import decode as jdec
from fa2_triton_tpu.ops import quant as jquant
from fa2_triton_tpu.runtime import Engine as JaxEngine
from fa2_triton_tpu.runtime import kv_cache as jkv
from fa2_triton_tpu.runtime import paged_cache as jpc

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.models import llama as tl  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.ops import decode as tdec  # noqa: E402
from fa2_triton_tpu_torch.runtime import Engine, kv_cache as tkv, paged_cache as tpc  # noqa: E402
from fa2_triton_tpu_torch.runtime import serving as tserving  # noqa: E402

PAGED_TOL = 2e-5
LP_TOL = 1e-4
QDTYPES = {None: (None, None), "int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
J_CFG = jl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=512, dtype=jnp.float32)
T_CFG = tl.LlamaConfig(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                       hidden_dim=256, max_seq_len=512, dtype=torch.float32)
PROMPT_LENS = (9, 11, 300)
NEW = (5, 6, 4)


def _bits(x) -> np.ndarray:
    """A 1- or 4-byte numpy, JAX or torch array as its raw bits."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int8) if x.dtype == torch.float8_e4m3fn else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8 if a.itemsize == 1 else np.uint32)


def _to_torch(a, dtype):
    a = np.asarray(a)
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.view(np.int8).copy()).view(dtype)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- decode --

def _shuffled_pool(k, v, lens, page, seed, qname):
    """Write contiguous [B, Hkv, S, D] fp32 k/v (quantized on the JAX side)
    into a shuffled page pool; table entries past each slot's last live
    page point at the reserved page 0. Returns the JAX and torch operands."""
    B, Hkv, S, D = k.shape
    M = S // page
    rng = np.random.RandomState(seed)
    perm = rng.permutation(B * M) + 1
    tables = np.zeros((B, M), np.int32)
    for b in range(B):
        live = -(-int(lens[b]) // page)
        tables[b, :live] = perm[b * M:b * M + live]
    n_pages = B * M + 1
    jq, tq = QDTYPES[qname]
    out = {}
    for name, x in (("k", k), ("v", v)):
        if jq is None:
            vals, sc = jnp.asarray(x), None
        else:
            vals, sc = jquant.quantize_tensor(jnp.asarray(x), jq)
            sc = np.asarray(sc)[..., 0]                      # [B, Hkv, S]
        vals = np.asarray(vals)
        pool = np.zeros((n_pages, Hkv, page, D), vals.dtype)
        spool = np.ones((n_pages, Hkv, 1, page), np.float32)
        for b in range(B):
            for i in range(M):
                pool[perm[b * M + i]] = vals[b, :, i * page:(i + 1) * page]
                if sc is not None:
                    spool[perm[b * M + i], :, 0] = sc[b, :, i * page:(i + 1) * page]
        out[name] = pool
        out[name + "_scale"] = spool if sc is not None else None
    return tables, out, tq


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
@pytest.mark.parametrize("kw", [dict(), dict(window_left=150, softcap=2.0)])
def test_paged_decode_matches_jax(qname, kw):
    """Shuffled pages at page 128, lens ragged (1 to a full table)."""
    B, Hq, Hkv, D, page, S = 3, 8, 2, 128, 128, 512
    rng = np.random.RandomState(0)
    lens = np.array([S, 130, 1], np.int32)
    q = rng.normal(0, 0.5, (B, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, Hkv, S, D)).astype(np.float32)
    tables, pool, tq = _shuffled_pool(k, v, lens, page, 1, qname)
    jargs = [jnp.asarray(pool["k"]), jnp.asarray(pool["v"]), jnp.asarray(tables), jnp.asarray(lens)]
    targs = [_to_torch(pool["k"], tq), _to_torch(pool["v"], tq), torch.from_numpy(tables),
             torch.from_numpy(lens)]
    if qname is not None:
        jargs += [jnp.asarray(pool["k_scale"]), jnp.asarray(pool["v_scale"])]
        targs += [torch.from_numpy(pool["k_scale"]), torch.from_numpy(pool["v_scale"])]
    j = jdec.paged_decode_attention(jnp.asarray(q), *jargs, **kw)
    t = tdec.paged_decode_attention(torch.from_numpy(q), *targs, **kw)
    assert t.shape == q.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=PAGED_TOL)
    # The plain twin gathers the same rows: paged equals contiguous exactly.
    kc, vc = (tdec._gather_pages(x, targs[2]) for x in targs[:2])
    sc = [tdec._gather_scales(x, targs[2]) for x in targs[4:]]
    torch.testing.assert_close(
        tdec.decode_attention(torch.from_numpy(q), kc, vc, targs[3], *sc, **kw), t, rtol=0, atol=0)


def test_paged_decode_rules_raise():
    q = torch.zeros(2, 4, 64)
    pool = torch.zeros(5, 2, 128, 64)
    lens = torch.ones(2, dtype=torch.int32)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tdec.paged_decode_attention(q, pool, pool, tables.long(), lens)
    with pytest.raises(ValueError, match="contiguous int32"):
        tdec.paged_decode_attention(q, pool, pool, torch.zeros(2, 4, dtype=torch.int32)[:, ::2],
                                    lens)
    with pytest.raises(ValueError, match="multiple of 128"):
        tdec.paged_decode_attention(q, pool[:, :, :64], pool[:, :, :64], tables, lens)
    p8 = pool.to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="queue C"):
        tdec.paged_decode_attention(q, p8, p8, tables, lens)
    with pytest.raises(ValueError, match=r"\[5, 2, 1, 128\]"):
        s = torch.ones(2, 2, 1, 128)   # the contiguous layout, not the pool's
        tdec.paged_decode_attention(q, p8, p8, tables, lens, s, s)


# ------------------------------------------------------------- allocator --

def _scripted(cache, write):
    """The same allocator and write sequence on a JAX or a port cache:
    allocation, release and refill, a window release, writes across page
    boundaries (2 slots x 5 tokens at offsets 126 / 300)."""
    Hkv, D = 2, 48
    rng = np.random.RandomState(3)
    cache.ensure_capacity(0, 200)       # 2 pages
    cache.ensure_capacity(1, 100)       # 1 page
    cache.ensure_capacity(2, 300)       # 3 pages
    cache.release(1)
    cache.ensure_capacity(1, 400)       # 4 pages, reusing slot 1's
    cache.release_prefix(2, 2)          # slot 2's first two logical pages
    cache.ensure_capacity(2, 500)
    cache.ensure_capacity(0, 305)
    for li in range(2):
        for offs in ([126, 300, 0], [300, 126, 0]):
            new = [rng.normal(0, 1, (3, 5, Hkv, D)).astype(np.float32) for _ in range(2)]
            write(li, *new, np.array(offs, np.int32))
    return cache


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_paged_cache_state_matches_jax_bitwise(qname):
    jq, tq = QDTYPES[qname]
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=48, page_size=128, n_pages=12, n_slots=3,
              max_seq=640)
    jc = jpc.PagedKVCache(jpc.PagedCacheConfig(**kw, qdtype=jq, compute_dtype=jnp.float32))
    tc = tpc.PagedKVCache(tpc.PagedCacheConfig(**kw, qdtype=tq, compute_dtype=torch.float32),
                          device="cpu")
    # Slots 0 and 1 write inside their pages; slot 2's writes at 0 land on
    # the reserved page 0 through its released table entries.
    _scripted(jc, lambda li, k, v, pos: jc.write_tokens(li, jnp.asarray(k), jnp.asarray(v),
                                                        jnp.asarray(pos)))
    _scripted(tc, lambda li, k, v, pos: tc.write_tokens(li, torch.from_numpy(k),
                                                        torch.from_numpy(v), torch.from_numpy(pos)))
    assert tc._free == jc._free
    assert tc.free_pages == jc.free_pages
    assert tc._slot_pages == jc._slot_pages and tc._slot_freed == jc._slot_freed
    np.testing.assert_array_equal(tc._tables, jc._tables)
    np.testing.assert_array_equal(tc.tables_device().numpy(), np.asarray(jc.tables_device()))
    np.testing.assert_array_equal(tc._refs, jc._refs)
    for tp, jp in zip(tc.pools, jc.pools):
        assert set(tp) == set(jp)
        for name in tp:
            j, t = np.asarray(jp[name]), tp[name]
            if name in ("k", "v"):
                # Both pad D 48 with zeros: JAX to 128 lanes, the port to the
                # kernels' 64.
                assert t.shape[-1] == tc.cfg.head_dim_padded == 64
                assert not np.asarray(jp[name])[..., 48:].astype(np.float32).any()
                assert not t[..., 48:].float().any()
                j, t = j[..., :48], t[..., :48]
            np.testing.assert_array_equal(_bits(t), _bits(j))
    # `attention` reads layer 1 through the tables (slot 2's released
    # entries included); JAX takes q padded to its 128-lane D, so the
    # softmax scale of D = 48 is given.
    q = np.random.RandomState(4).normal(0, 1, (3, 4, 48)).astype(np.float32)
    lens = np.array([305, 400, 305], np.int32)
    t = tc.attention(1, torch.from_numpy(np.pad(q, ((0, 0), (0, 0), (0, 16)))),
                     torch.from_numpy(lens), softmax_scale=48 ** -0.5)
    j = jc.attention(1, jnp.pad(jnp.asarray(q), ((0, 0), (0, 0), (0, 80))), jnp.asarray(lens),
                     softmax_scale=48 ** -0.5)
    np.testing.assert_allclose(t.numpy()[..., :48], np.asarray(j)[..., :48], rtol=0,
                               atol=PAGED_TOL)


def test_paged_cache_exhaustion_raises():
    cfg = tpc.PagedCacheConfig(n_layers=1, n_kv_heads=1, head_dim=64, page_size=128, n_pages=4,
                               n_slots=2, max_seq=256, compute_dtype=torch.float32)
    cache = tpc.PagedKVCache(cfg, device="cpu")
    assert cache.free_pages == 3          # page 0 reserved
    cache.ensure_capacity(0, 200)
    cache.ensure_capacity(1, 100)
    with pytest.raises(MemoryError):
        cache.ensure_capacity(1, 200)
    with pytest.raises(ValueError, match="max_seq"):
        cache.ensure_capacity(0, 257)
    cache.release(0)
    assert cache.free_pages == 2 and cache._refs.tolist() == [0, 0, 0, 1]


@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_write_kv_quantized_matches_jax_bitwise(qname):
    jq, tq = QDTYPES[qname]
    kw = dict(n_layers=1, n_kv_heads=2, head_dim=48, max_seq=200, n_slots=3)
    jcfg = jkv.KVCacheConfig(**kw, qdtype=jq, compute_dtype=jnp.float32)
    tcfg = tkv.KVCacheConfig(**kw, qdtype=tq, compute_dtype=torch.float32)
    jc, tc = jkv.init_cache(jcfg)[0], tkv.init_cache(tcfg, device="cpu")[0]
    rng = np.random.RandomState(5)
    for S, offs in ((7, [0, 100, 193]), (1, [7, 0, 199])):
        k, v = (rng.normal(0, 1, (3, S, 2, 48)).astype(np.float32) for _ in range(2))
        jc = jkv.write_kv(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(offs, jnp.int32), jcfg)
        tkv.write_kv(tc, torch.from_numpy(k), torch.from_numpy(v), torch.tensor(offs), tcfg)
    for name in ("k", "v", "k_scale", "v_scale"):
        j, t = np.asarray(jc[name]), tc[name]
        if name in ("k", "v"):
            # Padded to the kernels' 64 (JAX: 128) with zeros, which leave the
            # scales as they are.
            assert t.shape[-1] == 64 and not t[..., 48:].float().any()
            j, t = j[..., :48], t[..., :48]
        np.testing.assert_array_equal(_bits(t), _bits(j))


# ---------------------------------------------------------------- engine --

@pytest.fixture(scope="module")
def models():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    return jp, llama_from_jax_params(jax.tree.map(np.asarray, jp), T_CFG, device="cpu")


class _Margins:
    """Records the top-1 margin of every served logits row of a live
    request (decode rows of idle slots excluded)."""

    def __init__(self, engine, monkeypatch):
        self.min = float("inf")
        pick = tserving.greedy_tokens_with_logprobs

        def spy(logits):
            rows = range(logits.shape[0])
            if logits.shape[0] == len(engine.slot_req):
                rows = [i for i in rows if engine.slot_req[i] is not None]
            if rows:
                top2 = logits[list(rows)].topk(2, dim=-1).values
                self.min = min(self.min, float((top2[:, 0] - top2[:, 1]).min()))
            return pick(logits)
        monkeypatch.setattr(tserving, "greedy_tokens_with_logprobs", spy)


def _serve(engine, prompts, new):
    reqs = [engine.submit(p, n) for p, n in zip(prompts, new)]
    engine.run()
    assert all(r.done and len(r.out_tokens) == n for r, n in zip(reqs, new))
    return reqs


def _check_engines(j_reqs, t_reqs, margins):
    assert margins.min > 10 * LP_TOL, margins.min
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.out_tokens == jr.out_tokens
        assert tr.folded == jr.folded
        np.testing.assert_allclose(tr.out_logprobs, jr.out_logprobs, rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("kw", [dict(paged=True), dict(qname="int8"),
                                dict(paged=True, qname="fp8", page_size=128)],
                         ids=["paged", "int8", "paged-fp8"])
def test_engine_modes_match_jax(models, monkeypatch, kw):
    jp, tm = models
    kw = dict(kw)
    jq, tq = QDTYPES[kw.pop("qname", None)]
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in PROMPT_LENS]
    j_engine = JaxEngine(jp, J_CFG, n_slots=2, max_seq=512, qdtype=jq, **kw)
    j_reqs = _serve(j_engine, prompts, NEW)
    engine = Engine(tm, T_CFG, n_slots=2, max_seq=512, qdtype=tq, **kw)
    margins = _Margins(engine, monkeypatch)
    t_reqs = _serve(engine, prompts, NEW)
    if kw.get("paged"):
        assert engine.pcache.free_pages == engine.kv_cfg.n_pages - 1
        assert engine.kv_cfg.page_size == kw.get("page_size", 512)
    else:
        # The live rows of the last request in each slot: stored values
        # bitwise, scales (amax of fp32 k/v) to fp32 noise.
        for jc, tc in zip(j_engine.caches, engine.caches):
            assert tc["k"].dtype == tq and set(tc) == set(jc)
            assert tc["k"].shape[-1] == 64 and not tc["k"][..., 32:].float().any()
            for s, n in enumerate(engine.lens_np):
                for name in ("k", "v"):
                    np.testing.assert_array_equal(_bits(tc[name][s, :, :n, :32]),
                                                  _bits(np.asarray(jc[name])[s, :, :n, :32]))
                    np.testing.assert_allclose(tc[name + "_scale"][s, ..., :n].numpy(),
                                               np.asarray(jc[name + "_scale"])[s, ..., :n],
                                               rtol=1e-5, atol=0)
    _check_engines(j_reqs, t_reqs, margins)


def test_engine_preemption_matches_jax(models, monkeypatch):
    """Page pool exhausted mid-generation (tests/test_serving.py:133-148 at
    page 128: 3 usable pages, 2 slots that each need 2): the slot with the
    most pages is preempted, its tokens fold into its prompt, and it
    resumes to JAX's tokens."""
    jp, tm = models
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 128, size=100).tolist() for _ in range(2)]
    kw = dict(n_slots=2, max_seq=256, paged=True, n_pages=4, page_size=128)
    j_reqs = _serve(JaxEngine(jp, J_CFG, **kw), prompts, (40, 40))
    engine = Engine(tm, T_CFG, **kw)
    margins = _Margins(engine, monkeypatch)
    t_reqs = _serve(engine, prompts, (40, 40))
    assert any(r.folded for r in t_reqs)
    _check_engines(j_reqs, t_reqs, margins)
    assert engine.pcache.free_pages == 3


def test_sliding_window_releases_pages_like_jax(models):
    """All-layer window 64 (tests/test_prefix_cache.py:220-247): pages
    behind the window return to the pool mid-generation; the free-page
    count after every step equals JAX's, and tokens equal JAX's."""
    jp, _ = models
    jcfg = dataclasses.replace(J_CFG, sliding_window=64)
    tcfg = dataclasses.replace(T_CFG, sliding_window=64)
    tm = llama_from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompt = np.random.RandomState(10).randint(0, 128, size=250).tolist()
    seen, engines = [], []
    for eng in (JaxEngine(jp, jcfg, n_slots=1, max_seq=512, paged=True, page_size=128),
                Engine(tm, tcfg, n_slots=1, max_seq=512, paged=True, page_size=128)):
        req = eng.submit(prompt, max_new_tokens=10)
        free = []
        while not req.done:
            eng.step()
            free.append(eng.pcache.free_pages)
        seen.append((req.out_tokens, free))
        engines.append(eng)
    assert seen[1] == seen[0]
    total = engines[1].pcache.cfg.n_pages - 1   # 512 / 128 pages; page 0 reserved
    # Prefill took 2 pages; the first decode step (lens 250) releases
    # logical page 0, behind the window, and needs no new one.
    assert seen[1][1][0] == total - 1
    assert seen[1][1][-1] == total


def test_per_layer_window_keeps_pages_like_the_contiguous_engine():
    """window_pattern=(False, True): only layer 1 slides, so layer 0 still
    reads the pages behind the window and none may be released. The JAX
    paged Engine releases them anyway (ROADMAP.md queue C,
    `runtime/serving.py:854-860`), so the port's paged Engine is held to
    the JAX CONTIGUOUS Engine: tokens equal, log-probs within 1e-4, and no
    page comes back before the request ends."""
    kw = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
              max_seq_len=512, sliding_window=64, window_pattern=(False, True))
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **kw)
    jp = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tm = llama_from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompt = np.random.RandomState(10).randint(0, 128, size=250).tolist()
    eng = Engine(tm, tcfg, n_slots=1, max_seq=512, paged=True, page_size=128)
    req = eng.submit(prompt, max_new_tokens=10)
    free = []
    while not req.done:
        eng.step()
        free.append(eng.pcache.free_pages)
    total = eng.pcache.cfg.n_pages - 1
    # Prefill takes 2 pages and the 257th token a third; none returns early.
    assert free[0] == total - 2 and free[-1] == total, free
    assert all(a >= b for a, b in zip(free[:-1], free[1:-1])), free
    j_engine = JaxEngine(jp, jcfg, n_slots=1, max_seq=512)
    j_req = j_engine.submit(prompt, max_new_tokens=10)
    j_engine.run()
    assert req.out_tokens == j_req.out_tokens
    np.testing.assert_allclose(req.out_logprobs, j_req.out_logprobs, rtol=0, atol=LP_TOL)



def test_failed_admission_keeps_no_pages(models):
    """Two 200-token prompts on 3 usable pages of 128: the second admission
    finds one of the two pages it needs. The port returns that page at
    once; the reference leaves it on the empty slot (ROADMAP queue C), so
    the pool is held to the port's contract only: every page comes back.
    The tokens are JAX's."""
    jp, tm = models
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 128, size=200).tolist() for _ in range(2)]
    kw = dict(n_slots=2, max_seq=256, paged=True, n_pages=4, page_size=128)
    j_reqs = _serve(JaxEngine(jp, J_CFG, **kw), prompts, (10, 10))
    engine = Engine(tm, T_CFG, **kw)
    t_reqs = _serve(engine, prompts, (10, 10))
    assert [r.out_tokens for r in t_reqs] == [r.out_tokens for r in j_reqs]
    assert engine.pcache.free_pages == 3 and engine.pcache._slot_pages == [[], []]


@pytest.mark.parametrize("head_dim", [96, 16])
def test_paged_int8_engine_at_head_dims_off_the_kernel_widths_matches_jax(monkeypatch, head_dim):
    """A paged int8 Engine at a model head dim the decode kernel is not
    built for (Phi-3-mini's 96, JAX's serving dryrun's 16): the pool is
    128 / 64 wide (JAX's 128), written zero-padded, and its stored int8
    values and scales equal JAX's first head_dim columns (the int8 rule of
    ROADMAP.md queue C "int8 rounding": a k / v whose fp32 value sits on a
    rounding boundary may store one step apart, on at most 1e-3 of the
    values) before tokens and log-probs are held to JAX's (equal tokens,
    1e-4, the top-1 margins above 10x that)."""
    jcfg = dataclasses.replace(J_CFG, head_dim=head_dim)
    tcfg = dataclasses.replace(T_CFG, head_dim=head_dim)
    jp = jl.init_params(jax.random.PRNGKey(head_dim), jcfg)
    tm = llama_from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.RandomState(head_dim)
    prompts = [rng.randint(0, 128, size=n).tolist() for n in (9, 11, 140)]
    kw = dict(n_slots=2, max_seq=512, paged=True, page_size=128)
    j_engine = JaxEngine(jp, jcfg, qdtype=jnp.int8, **kw)
    j_reqs = _serve(j_engine, prompts, NEW)
    engine = Engine(tm, tcfg, qdtype=torch.int8, **kw)
    margins = _Margins(engine, monkeypatch)
    t_reqs = _serve(engine, prompts, NEW)
    assert engine.kv_cfg.head_dim_padded == {96: 128, 16: 64}[head_dim]
    for tp, jp_ in zip(engine.pcache.pools, j_engine.pcache.pools):
        for name in ("k", "v"):
            assert tp[name].shape[-1] == engine.kv_cfg.head_dim_padded
            assert not tp[name][..., head_dim:].any()
            d = np.abs(tp[name][..., :head_dim].numpy().astype(np.int32)
                       - np.asarray(jp_[name])[..., :head_dim].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, ((d > 0).sum(), d.size)
            np.testing.assert_allclose(tp[name + "_scale"].numpy(),
                                       np.asarray(jp_[name + "_scale"]), rtol=1e-5, atol=0)
    _check_engines(j_reqs, t_reqs, margins)
