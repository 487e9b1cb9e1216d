"""CUDA kernels of the PyTorch port against their plain PyTorch twins, on
the card. Marked `cuda`: without a GPU every test here skips. On a machine
with one (no JAX needed):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: fp32 kernel vs fp32 plain 1e-4 max abs (summation order only);
fp16/bf16 kernel error vs the fp32 plain at most 2x the low-precision plain
version's own error + 5e-5 (the FA rule of tests/utils.py:19-20); base-2
lse 1e-4 (fp32 math on both sides). Gradients: fp32 kernel vs fp32 plain
1e-4 x (1 + max |grad|) (sums of a few hundred fp32 products in another
order); fp16/bf16 the FA gradient contract of
tests/utils.py:compare_results_fa: at most 3x the low-precision plain
version's error + 1e-5, with its dV waiver (summed dV error < 1e-4).
"""
import pytest

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import decode, flash_bwd, flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

pytestmark = pytest.mark.cuda

# The head dims past 256 that the dense forward, the dq + dk/dv pair, dbias,
# the fused backward schedules, decode and the packed kernels are built for
# (their own tilings there).
WIDE = [384, 512]
# Head dims past 512 (any multiple of 128: the forward, the dq + dk/dv pair
# and decode split the output columns over blocks; D 640 ends in a chunk
# half as wide, 1152 in one of 128).
WIDER = [640, 1024, 1152]


@pytest.fixture
def prior_routes(monkeypatch):
    """The prior's routes (JAX's gates), the card's tuning table off: for
    the tests that assert those routes' launches."""
    monkeypatch.setenv("FA2_DISABLE_TUNING_TABLE", "1")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(out, ref32, plain_lowp, dtype):
    err = (out.float() - ref32.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        yard = (plain_lowp.float() - ref32.float()).abs().max().item()
        assert err <= 2 * yard + 5e-5, (err, yard)


FWD_CASES = [
    dict(),                                                   # padded causal (the prefill)
    dict(causal=False),
    dict(window=(17, 0)),
    dict(causal=False, window=(9, 5)),
    dict(causal=False, window=(-1, 3)),
    dict(softcap=4.0),
    dict(sk=300),                                             # Sq < Sk, bottom-right diagonal
    dict(q_off=40, sq=60, sk=100),                            # a query chunk at a global offset
    dict(hkv=4),
    dict(hkv=1),
    dict(sq=333, sk=333, lens=(333, 256)),                    # several kv tiles, a ragged last q tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("case", range(len(FWD_CASES)))
def test_flash_fwd_kernel_matches_plain(dev, dtype, D, case):
    c = FWD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(case * 7 + D)
    B, Hq, Hkv = 2, 4, c.get("hkv", 2)
    Sq, Sk = c.get("sq", 200), c.get("sk", 200)
    q32 = torch.randn(B, Sq, Hq, D, generator=g, device=dev) * 0.5
    k32 = torch.randn(B, Sk, Hkv, D, generator=g, device=dev) * 0.5
    v32 = torch.randn(B, Sk, Hkv, D, generator=g, device=dev) * 0.5
    q_off = c.get("q_off", 0)
    if "q_off" in c:
        lens = torch.tensor([[q_off + Sq, Sk]] * B, dtype=torch.int32, device=dev)
    elif "lens" in c:
        lens = torch.tensor([[n, n] for n in c["lens"]], dtype=torch.int32, device=dev)
    elif Sq == Sk:
        lens = torch.tensor([[Sq, Sk], [Sq - 77, Sk - 77]], dtype=torch.int32, device=dev)
    else:
        lens = torch.tensor([[Sq, Sk]] * B, dtype=torch.int32, device=dev)
    kw = dict(causal=c.get("causal", True), softmax_scale=D ** -0.5,
              window=c.get("window", (-1, -1)), softcap=c.get("softcap", 0.0))
    t = lambda x: x.transpose(1, 2)
    ref, _ = flash_fwd.flash_attn_forward_plain(t(q32), t(k32), t(v32), lens, q_off, 0, **kw)
    q, k, v = (t(x.to(dtype)) for x in (q32, k32, v32))
    before = flash_fwd.LAUNCHES
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, q_off, 0, **kw)
    assert flash_fwd.LAUNCHES == before + 1
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(q, k, v, lens, q_off, 0, **kw)
    torch.cuda.synchronize()
    _check(o, ref, o_pl, dtype)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_pl))
    fin = torch.isfinite(lse_pl)
    assert (lse[fin] - lse_pl[fin]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("route", ["generic", "strip"])
def test_flash_fwd_kernel_ignores_nan_padding(dev, dtype, D, route):
    """Rows past q_len / kv_len may hold NaN (padding), and the tensor cores
    give 0 x NaN = NaN: the 16-bit forward zero-fills them on load, so o and
    lse equal those of zero-filled padding bit for bit, with o = 0 and
    lse = -inf on the padded rows (the generic call and the strip)."""
    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v = ((torch.randn(2, 300, h, D, generator=g, device=dev) * 0.5).to(dtype).transpose(1, 2)
               for h in (4, 2, 2))
    lens = torch.tensor([[300, 300], [211, 211]], dtype=torch.int32, device=dev)
    kw = dict(softmax_scale=D ** -0.5)
    if route == "generic":
        run = lambda *x: flash_fwd.flash_attn_forward(*x, lens, causal=True, **kw)  # noqa: E731
    else:
        run = lambda *x: flash_fwd.flash_attn_forward_causal_strip(*x, lens, **kw)  # noqa: E731
    for x in (q, k, v):
        x[1, :, 211:] = 0
    o0, lse0 = run(q, k, v)
    for x in (q, k, v):
        x[1, :, 211:] = float("nan")
    o1, lse1 = run(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o1.contiguous().view(torch.int16), o0.contiguous().view(torch.int16))
    assert torch.equal(lse1.view(torch.int32), lse0.view(torch.int32))
    assert torch.isfinite(o1).all() and not o1[1, :, 211:].any()
    assert torch.isneginf(lse1[1, :, 211:]).all() and torch.isfinite(lse1[:, :, :211]).all()


def test_flash_fwd_kernel_is_bitwise_repeatable(dev):
    """5 runs of the 16-bit forward with dropout, identical o and lse (no
    atomics; each accumulator has one owner and a fixed order)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = ((torch.randn(2, 333, h, 128, generator=g, device=dev) * 0.5)
               .to(torch.bfloat16).transpose(1, 2) for h in (8, 2, 2))
    lens = torch.tensor([[333, 333], [256, 256]], dtype=torch.int32, device=dev)
    runs = [flash_fwd.flash_attn_forward(q, k, v, lens, causal=True, softmax_scale=128 ** -0.5,
                                         dropout_p=0.1, dropout_seed=7) for _ in range(5)]
    torch.cuda.synchronize()
    for o, lse in runs[1:]:
        assert torch.equal(o.contiguous().view(torch.int16), runs[0][0].contiguous().view(torch.int16))
        assert torch.equal(lse.view(torch.int32), runs[0][1].view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", [dict(), dict(window_left=50), dict(softcap=3.0)])
def test_decode_kernel_matches_plain(dev, dtype, D, G, kw):
    g = torch.Generator(device=dev).manual_seed(D + G)
    lens = [1, 2, 63, 64, 65, 700, 1000]
    B, Hkv, S_max = len(lens), 2, 1024
    q32 = torch.randn(B, Hkv * G, D, generator=g, device=dev) * 0.5
    k32 = torch.randn(B, Hkv, S_max, D, generator=g, device=dev) * 0.5
    v32 = torch.randn(B, Hkv, S_max, D, generator=g, device=dev) * 0.5
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    ref = decode.decode_attention_plain(q32, k32, v32, kv_lens, **kw)
    q, k, v = (x.to(dtype) for x in (q32, k32, v32))
    before = decode.LAUNCHES
    o = decode.decode_attention(q, k, v, kv_lens, **kw)
    assert decode.LAUNCHES == before + 1
    torch.cuda.synchronize()
    _check(o, ref, decode.decode_attention_plain(q, k, v, kv_lens, **kw), dtype)


def test_decode_kernel_ignores_nan_past_kv_len(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 4, 128, generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn(2, 2, 256, 128, generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn(2, 2, 256, 128, generator=g, device=dev, dtype=torch.bfloat16)
    kv_lens = torch.tensor([3, 100], dtype=torch.int32, device=dev)
    base = decode.decode_attention(q, k, v, kv_lens)
    k[0, :, 3:] = float("nan")
    v[1, :, 100:] = float("nan")
    torch.testing.assert_close(decode.decode_attention(q, k, v, kv_lens), base, rtol=0, atol=0)


def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    # Head dims: past 512 `flash_attn_func` computes (the forward and the dq
    # + dk/dv pair take any multiple of 128); dbias, the forced fused
    # backward schedules and the packed kernels raise (ROADMAP.md queue A
    # item 1(c)).
    from fa2_triton_tpu_torch.ops import varlen

    q = torch.zeros(1, 8, 2, 640, device=dev, dtype=torch.bfloat16)
    assert flash_attn_func(q, q, q, causal=True).shape == q.shape
    qw = torch.zeros(1, 2, 8, 640, device=dev, dtype=torch.bfloat16)
    lens8 = torch.tensor([[8, 8]], dtype=torch.int32, device=dev)
    bias = torch.zeros(1, 2, 8, 8, device=dev)
    with pytest.raises(ValueError, match=r"head_dim 640 > 512.*dbias.*queue A item 1\(c\)"):
        flash_bwd.flash_attn_backward(qw, qw, qw, qw, qw, torch.zeros(1, 2, 8, device=dev), lens8,
                                      0, 0, bias, causal=True, softmax_scale=0.05,
                                      compute_dbias=True)
    xp = torch.zeros(128, 2, 640, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head_dim 640 > 512.*queue A item 1\(c\)"):
        varlen.flash_attn_varlen_func(xp, xp, xp, [0, 128], block_q=128, block_kv=128)
    for route in ("tri_square", "worklist", "split"):
        with pytest.raises(ValueError, match=r"head_dim 640 > 512.*queue A item 1\(c\)"):
            flash_bwd.flash_attn_backward(qw, qw, qw, qw, qw, torch.zeros(1, 2, 8, device=dev),
                                          lens8, causal=True, softmax_scale=0.05,
                                          static_skip=True, route=route)
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        flash_attn_func(q, q, q, causal=True)
    q = torch.zeros(1, 8, 2, 64, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        flash_attn_func(q, q, q, causal=True, dropout_p=0.1)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="compute_dbias"):
        flash_bwd.flash_attn_backward(q, q, q, q, q, lse, torch.ones(1, 2, dtype=torch.int32, device=dev),
                                      causal=True, softmax_scale=0.125, compute_dbias=True)
    qd = torch.zeros(2, 6, 64, device=dev)
    cache = torch.zeros(2, 2, 128, 64, device=dev)
    with pytest.raises(ValueError, match="Hq / Hkv"):
        decode.decode_attention(qd, cache, cache, torch.ones(2, dtype=torch.int32, device=dev))
    # The 16-bit forward copies 16-byte rows (cp.async): a row stride of 68
    # elements is refused, where the FMA kernels' 4-element loads take it.
    x = torch.zeros(1, 2, 8, 68, device=dev, dtype=torch.bfloat16)[..., :64]
    lens = torch.tensor([[8, 8]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        flash_fwd.flash_attn_forward(x, x, x, lens, causal=True, softmax_scale=0.125)
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        flash_fwd.flash_attn_forward_causal_strip(x, x, x, lens, softmax_scale=0.125)
    with pytest.raises(ValueError, match="multiple of 8 elements"):   # the split's calls too
        flash_fwd.flash_attn_forward_causal_diag(x, x, x, lens, T=64, softmax_scale=0.125)
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        flash_fwd.flash_attn_forward_rect(x, x, x, lens, row0=0, col0=0, nrows=8, ncols=8,
                                          softmax_scale=0.125)
    # So does the 16-bit dq + dk/dv pair (the do it is handed is re-laid).
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        flash_bwd.flash_attn_backward(x, x, x, x, x, lse, lens, causal=True, softmax_scale=0.125)


def test_engine_on_cuda_matches_engine_on_cpu(dev):
    from fa2_triton_tpu_torch.models import LlamaConfig, init_params
    from fa2_triton_tpu_torch.runtime import Engine

    cfg = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      hidden_dim=512, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = init_params(torch.Generator().manual_seed(0), cfg).to(dev)
    prompts = [[(7 * i + 3 * j) % 256 for j in range(n)] for i, n in enumerate((5, 40, 130))]
    outs = []
    for model in (cpu, gpu):
        eng = Engine(model, cfg, n_slots=2, max_seq=512)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        outs.append(reqs)
    for a, b in zip(*outs):
        assert a.out_tokens == b.out_tokens
        torch.testing.assert_close(torch.tensor(b.out_logprobs), torch.tensor(a.out_logprobs),
                                   rtol=0, atol=1e-3)


def _check_grads(grads, refs, plains, dtype):
    """FA gradient contract per gradient (dV / dbias with the dV waiver)."""
    for name, g, r, pl in zip(("dq", "dk", "dv", "dbias"), grads, refs, plains):
        err = (g.float() - r.float()).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-4 * (1 + r.float().abs().max().item()), (name, err)
            continue
        yard = (pl.float() - r.float()).abs().max().item()
        if err <= 3 * yard + 1e-5:
            continue
        assert name in ("dv", "dbias") and (g.float() - r.float()).abs().sum().item() < 1e-4, \
            (name, err, yard)


BWD_CASES = [
    dict(),                                                   # padded causal GQA (group 4)
    dict(causal=False),
    dict(window=(17, 0)),
    dict(causal=False, window=(9, 5)),
    dict(softcap=4.0),
    dict(sk=300),                                             # Sq < Sk, causal with offset
    dict(sq=300),                                             # Sq > Sk: the first 100 rows dead
    dict(q_off=40, sq=60, sk=100),                            # a query chunk at a global offset
    dict(hkv=8),                                              # group 1
    dict(hkv=4),                                              # group 2
    dict(hkv=1),                                              # group 8
    dict(sq=333, sk=333, lens=(333, 256)),                    # several kv / q tiles, ragged last
]


def _bwd_inputs(dev, c, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Hq, Hkv = 2, 8, c.get("hkv", 2)
    Sq, Sk = c.get("sq", 200), c.get("sk", 200)
    q = torch.randn(B, Sq, Hq, D, generator=g, device=dev) * 0.5
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=dev) * 0.5
    v = torch.randn(B, Sk, Hkv, D, generator=g, device=dev) * 0.5
    do = torch.randn(B, Sq, Hq, D, generator=g, device=dev)
    q_off = c.get("q_off", 0)
    if "q_off" in c:
        lens = [[q_off + Sq, Sk]] * B
    elif "lens" in c:
        lens = [[n, n] for n in c["lens"]]
    elif Sq == Sk:
        lens = [[Sq, Sk], [Sq - 77, Sk - 77]]
    else:
        lens = [[Sq, Sk]] * B
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(causal=c.get("causal", True), softmax_scale=D ** -0.5,
              window=c.get("window", (-1, -1)), softcap=c.get("softcap", 0.0))
    return [x.transpose(1, 2) for x in (q, k, v, do)], lens, q_off, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("case", range(len(BWD_CASES)))
def test_flash_bwd_kernels_match_plain(dev, dtype, D, case):
    c = BWD_CASES[case]
    (q32, k32, v32, do32), lens, q_off, kw = _bwd_inputs(dev, c, D, case * 11 + D)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, q_off, 0, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, q_off, 0, **kw)
    q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, q_off, 0, **kw)
    before = dict(flash_bwd.LAUNCHES)
    grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, q_off, 0, **kw)
    assert flash_bwd.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert flash_bwd.LAUNCHES["flash_bwd_dkdv"] == before["flash_bwd_dkdv"] + 1
    assert flash_bwd.LAUNCHES["flash_bwd_dbias"] == before["flash_bwd_dbias"]
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, q_off, 0, **kw)
    torch.cuda.synchronize()
    for g, x in zip(grads, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype and torch.isfinite(g).all()
    _check_grads(grads, refs, plains, dtype)
    assert not grads[0][~torch.isfinite(lse)].any()   # rows with no valid column: exactly 0


BIAS_SHAPES = [(1, 1, 200, 200), (2, 1, 200, 200), (1, 8, 200, 200), (2, 8, 200, 200),
               (2, 1, 1, 200)]
# fp32 takes the FMA dbias kernel (its 32 x 16 tiles past D 256), fp16 /
# bf16 the tensor-core one (its tiles: 64 keys at D 64 / 128, 32 past, with
# one buffer of the step's tiles past D 256).
BIAS_DTYPE_DIMS = [(torch.float32, D) for D in [64] + WIDE] + [
    (dt, D) for dt in (torch.float16, torch.bfloat16) for D in [64, 128, 256] + WIDE]


@pytest.mark.parametrize("dtype,D", BIAS_DTYPE_DIMS)
@pytest.mark.parametrize("shape", BIAS_SHAPES)
@pytest.mark.parametrize("bias_fp32", [False, True])
def test_bias_forward_and_dbias_kernels_match_plain(dev, dtype, D, shape, bias_fp32):
    (q32, k32, v32, do32), lens, _, kw = _bwd_inputs(dev, dict(), D, 5)
    g = torch.Generator(device=dev).manual_seed(9)
    b32 = torch.randn(*shape, generator=g, device=dev)
    bfull = b32.expand(shape[0], shape[1], 200, 200)   # a zero-stride seq dim when shape[2] == 1
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, 0, 0, bfull, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, 0, 0, bfull,
                                               compute_dbias=True, **kw)
    q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
    bias = bfull if bias_fp32 else bfull.to(dtype)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, 0, 0, bias, **kw)
    o_pl, _ = flash_fwd.flash_attn_forward_plain(q, k, v, lens, 0, 0, bias, **kw)
    before = flash_bwd.LAUNCHES["flash_bwd_dbias"]
    grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, 0, 0, bias,
                                          compute_dbias=True, **kw)
    assert flash_bwd.LAUNCHES["flash_bwd_dbias"] == before + 1
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, 0, 0, bias,
                                                 compute_dbias=True, **kw)
    torch.cuda.synchronize()
    _check(o, o32, o_pl, dtype)
    assert grads[3].shape == (shape[0], shape[1], 200, 200) and grads[3].dtype == bias.dtype
    _check_grads(grads, refs, plains, dtype)


DBIAS_CASES = [
    dict(hkv=8),                                              # group 1
    dict(hkv=2, bias=(2, 1)),                                 # group 4, a [B, 1, S, S] bias
    dict(causal=False),
    dict(window=(17, 0)),                                     # whole tiles left of the window
    dict(causal=False, window=(9, 5)),
    dict(softcap=4.0),
    dict(q_off=40, sq=60, sk=100),                            # a query chunk at a global offset
    dict(kv_off=36, sk=164),                                  # a key chunk: rows 0-35 see nothing
    dict(sk=300),                                             # Sq < Sk
    dict(sq=300),                                             # Sq > Sk: the first 100 rows dead
]


def _live(lens, q_off, kv_off, Sq, Sk, kw, bias_batch, dev):
    """Where some batch row the bias serves keeps the element: [1 or B, 1, Sq, Sk]."""
    keep = flash_fwd._masks(lens, q_off, kv_off, Sq, Sk, kw["causal"], kw["window"], dev)
    return keep if bias_batch > 1 else keep.any(0, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE)
@pytest.mark.parametrize("case", range(len(DBIAS_CASES)))
def test_dbias_kernel_cases_match_plain(dev, dtype, D, case):
    """The tensor-core dbias kernel under GQA, masks, softcap and offsets
    (FA gradient contract, dbias with the dV waiver), one launch per call;
    every element that no batch row keeps is exactly 0, whole dead tiles
    included (the causal corner, left of the window, dead rows)."""
    c = dict(DBIAS_CASES[case])
    bias_b, bias_h = c.pop("bias", (1, 8))
    kv_off = c.pop("kv_off", 0)
    (q32, k32, v32, do32), lens, q_off, kw = _bwd_inputs(dev, c, D, case * 17 + D)
    Sq, Sk = q32.shape[2], k32.shape[2]
    if kv_off:
        lens = torch.tensor([[Sq, kv_off + Sk], [Sq - 77, kv_off + Sk - 77]], dtype=torch.int32,
                            device=dev)
    b32 = torch.randn(bias_b, bias_h, Sq, Sk, generator=torch.Generator(device=dev).manual_seed(D),
                      device=dev)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, q_off, kv_off, b32, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, q_off, kv_off,
                                               b32, compute_dbias=True, **kw)
    q, k, v, do, bias = (x.to(dtype) for x in (q32, k32, v32, do32, b32))
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, q_off, kv_off, bias, **kw)
    before = flash_bwd.LAUNCHES["flash_bwd_dbias"]
    grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, q_off, kv_off, bias,
                                          compute_dbias=True, **kw)
    assert flash_bwd.LAUNCHES["flash_bwd_dbias"] == before + 1
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, q_off, kv_off, bias,
                                                 compute_dbias=True, **kw)
    torch.cuda.synchronize()
    dbias = grads[3]
    assert dbias.shape == bias.shape and dbias.dtype == dtype and torch.isfinite(dbias).all()
    _check_grads(grads, refs, plains, dtype)
    dead = ~_live(lens, q_off, kv_off, Sq, Sk, kw, bias_b, dev).expand_as(dbias)
    assert not dbias[dead].any()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE)
def test_dbias_kernel_ignores_nan_padding(dev, dtype, D):
    """NaN in the rows past q_len / kv_len of q, k, v and do, and in every
    bias element that no batch row keeps: all four gradients (dbias of a
    per-head bias summed over the batch, and of a per-batch bias summed over
    the heads) equal those of zero-filled padding bit for bit."""
    (q, k, v, do), lens, _, kw = _bwd_inputs(dev, dict(), D, 3)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    for x in (q, k, v, do):
        x[1, :, 123:] = 0                       # batch row 1 has 123 valid rows
    qn, kn, vn, don = (x.clone() for x in (q, k, v, do))
    for x in (qn, kn, vn, don):
        x[1, :, 123:] = float("nan")
    g = torch.Generator(device=dev).manual_seed(D)
    for bias_b, bias_h in ((1, 8), (2, 1)):
        bias = torch.randn(bias_b, bias_h, 200, 200, generator=g, device=dev).to(dtype)
        bias_n = bias.masked_fill(~_live(lens, 0, 0, 200, 200, kw, bias_b, dev), float("nan"))

        def run(q, k, v, do, bias):
            o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, 0, 0, bias, **kw)
            return flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, 0, 0, bias,
                                                 compute_dbias=True, **kw)

        base, got = run(q, k, v, do, bias), run(qn, kn, vn, don, bias_n)
        torch.cuda.synchronize()
        assert torch.isnan(bias_n).any()
        for a, b in zip(got, base):
            assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
def test_bwd_kernels_ignore_nan_padding(dev, dtype, D):
    """Rows past q_len and columns past kv_len may hold NaN (padding): the
    kernels zero-fill them on load, so the gradients equal those of
    zero-filled padding bit for bit, and padded rows get exactly zero; the
    same for one region-mode call (`flash_attn_backward_rect`) whose rows
    and columns reach into the padding."""
    (q, k, v, do), lens, _, kw = _bwd_inputs(dev, dict(), D, 3)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    region = dict(row0=64, col0=0, nrows=136, ncols=128)

    def run(q, k, v, do):
        o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
        k_p = flash_bwd._prescale_k(k, kw["softmax_scale"])
        delta = flash_bwd.compute_delta(o, do, lse)
        rect = flash_bwd.flash_attn_backward_rect(q, k_p, v, do, lse, delta, lens, **region,
                                                  softmax_scale=kw["softmax_scale"])
        return flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw), rect

    base, base_rect = run(q, k, v, do)
    qn, kn, vn, don = (x.clone() for x in (q, k, v, do))
    for x in (qn, kn, vn, don):
        x[1, :, 123:] = float("nan")            # batch row 1 has 123 valid rows
    grads, rect = run(qn, kn, vn, don)
    torch.cuda.synchronize()
    for g, ref in zip(grads, base):
        assert torch.isfinite(g).all()
        assert torch.equal(g[0], ref[0]) and torch.equal(g[1, :, :123], ref[1, :, :123])
        assert not g[1, :, 123:].any()
    # The region's rows 64.. and columns 0..127: batch row 1 is live up to
    # region row 123 - 64 and column 123.
    for g, ref, live in zip(rect, base_rect, (123 - 64, 123, 123)):
        assert torch.isfinite(g).all()
        assert torch.equal(g[0], ref[0]) and torch.equal(g[1, :, :live], ref[1, :, :live])
        assert not g[1, :, live:].any()


def test_bwd_kernels_are_bitwise_repeatable(dev):
    """5 runs, identical dq / dk / dv / dbias (no atomics; the JAX side pins
    the same in tests/test_repeatability.py), and 5 runs with dropout."""
    (q, k, v, do), lens, _, kw = _bwd_inputs(dev, dict(hkv=1), 128, 4)
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    bias = torch.randn(1, 8, 200, 200, device=dev, dtype=torch.bfloat16)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, 0, 0, bias, **kw)
    runs = [flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, 0, 0, bias,
                                          compute_dbias=True, **kw) for _ in range(5)]
    drop = dict(dropout_p=0.1, dropout_seed=7)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw, **drop)
    drop_runs = [flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw, **drop)
                 for _ in range(5)]
    torch.cuda.synchronize()
    for rs in (runs, drop_runs):
        for run in rs[1:]:
            for a, b in zip(run, rs[0]):
                assert torch.equal(a, b)


def test_flash_attn_func_grads_go_through_the_kernels(dev):
    """The public API on CUDA tensors that require grad: the forward and
    backward kernels launch, and q / k / v / bias / lse gradients match the
    same call on the CPU (the plain twins), fp32."""
    rng = torch.Generator().manual_seed(0)
    q = torch.randn(2, 150, 8, 64, generator=rng) * 0.5
    k = torch.randn(2, 150, 2, 64, generator=rng) * 0.5
    v = torch.randn(2, 150, 2, 64, generator=rng) * 0.5
    bias = torch.randn(1, 8, 150, 150, generator=rng)
    mask = torch.arange(150)[None] < torch.tensor([150, 99])[:, None]
    do = torch.randn(2, 150, 8, 64, generator=rng)
    dl = torch.randn(2, 8, 150, generator=rng)
    grads = []
    for device in ("cpu", dev):
        leaves = [x.detach().to(device).requires_grad_() for x in (q, k, v, bias)]
        fwd0 = flash_fwd.LAUNCHES
        bwd0 = dict(flash_bwd.LAUNCHES)
        out, lse = flash_attn_func(*leaves[:3], attention_mask=mask.to(device),
                                   attention_bias=leaves[3], causal=True, return_lse=True)
        lse_term = torch.where(torch.isfinite(lse), lse, 0) * dl.to(device)
        ((out * do.to(device)).sum() + lse_term.sum()).backward()
        launched = (flash_fwd.LAUNCHES - fwd0,
                    *(flash_bwd.LAUNCHES[n] - bwd0[n] for n in sorted(bwd0)))
        assert launched == ((0, 0, 0, 0) if device == "cpu" else (1, 1, 1, 1)), launched
        grads.append([x.grad.cpu() for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_expanded_output_cotangent_is_relaid_for_the_kernels(dev):
    """`out.sum().backward()` hands the backward an expanded do (zero
    strides), which the kernels cannot read as it is: the wrapper copies it
    into their layout, and the gradients match the CPU's."""
    rng = torch.Generator().manual_seed(1)
    x = [torch.randn(2, 70, h, 64, generator=rng) * 0.5 for h in (4, 2, 2)]
    grads = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_() for t in x]
        flash_attn_func(*leaves, causal=True).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


# ------------------- packed varlen / block-sparse (B7, B8) -------------------

def _varlen_layout(lens, blocks):
    align = max(blocks)
    starts = [0]
    for l in lens[:-1]:
        starts.append(starts[-1] + -(-max(l, 1) // align) * align)
    return starts, starts[-1] + -(-max(lens[-1], 1) // align) * align


def _varlen_inputs(dev, T, Hq, Hkv, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, T, Hq, D, generator=g, device=dev) * 0.5
    k = torch.randn(1, T, Hkv, D, generator=g, device=dev) * 0.5
    v = torch.randn(1, T, Hkv, D, generator=g, device=dev) * 0.5
    do = torch.randn(1, T, Hq, D, generator=g, device=dev)
    return [x.transpose(1, 2) for x in (q, k, v, do)]


def _live_mask(starts, lens, T, dev):
    live = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, l in zip(starts, lens):
        live[s0:s0 + l] = True
    return live


def _varlen_check(dev, dtype, starts, qlens, kvlens, T, Hq, Hkv, D, seed, **kw):
    """Forward and backward kernels vs the plain twins (FA rule), launch
    counts, and exact zeros outside the live rows and on live rows that keep
    no column (o = 0, lse = -inf: a negative causal shift, a block-sparse
    row whose blocks hold no causal column)."""
    from fa2_triton_tpu_torch.ops import varlen

    q32, k32, v32, do32 = _varlen_inputs(dev, T, Hq, Hkv, D, seed)
    args = (starts, qlens, kvlens)
    o32, lse32 = varlen.flash_attn_varlen_forward_plain(q32, k32, v32, *args, **kw)
    refs = varlen.flash_attn_varlen_backward_plain(q32, k32, v32, do32, o32, lse32, *args, **kw)
    q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
    before = dict(varlen.LAUNCHES)
    o, lse = varlen.flash_attn_varlen_forward(q, k, v, *args, **kw)
    o_pl, lse_pl = varlen.flash_attn_varlen_forward_plain(q, k, v, *args, **kw)
    grads = varlen.flash_attn_varlen_backward(q, k, v, do, o, lse, *args, **kw)
    plains = varlen.flash_attn_varlen_backward_plain(q, k, v, do, o, lse, *args, **kw)
    torch.cuda.synchronize()
    assert {n: varlen.LAUNCHES[n] - before[n] for n in before} == \
        {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}
    _check(o, o32, o_pl, dtype)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_pl))
    fin = torch.isfinite(lse_pl)
    if fin.any():
        assert (lse[fin] - lse_pl[fin]).abs().max().item() <= 1e-4
    assert torch.all(lse[~fin] == float("-inf")) and not o[~fin].any()
    _check_grads(grads, refs, plains, dtype)
    q_live = _live_mask(starts, qlens, T, dev)
    kv_live = _live_mask(starts, kvlens, T, dev)
    assert not o[:, :, ~q_live].any() and torch.all(lse[:, :, ~q_live] == float("-inf"))
    assert not grads[0][:, :, ~q_live].any()
    assert not grads[1][:, :, ~kv_live].any() and not grads[2][:, :, ~kv_live].any()
    for gr in grads:
        assert torch.isfinite(gr).all()
    return o, lse, grads


# Rectangular blocks both ways: the 64-row tiles nest in either (and past D
# 256 the 32-row halves of a 64-row tile, the 16-bit dk/dv blocks and the
# fp32 blocks, sit at both ends of a user block).
VARLEN_BLOCKS = {64: (64, 128), 128: (128, 128), 256: (128, 64), 384: (128, 64), 512: (64, 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_varlen_kernels_match_plain(dev, dtype, D, causal, G):
    lens = (300, 1, 128, 77)          # ragged, length 1, a block multiple
    blocks = VARLEN_BLOCKS[D]
    starts, T = _varlen_layout(lens, blocks)
    _varlen_check(dev, dtype, starts, lens, lens, T, 8, 8 // G, D, seed=D + G + causal,
                  causal=causal, softmax_scale=D ** -0.5, block_q=blocks[0], block_kv=blocks[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [128] + WIDE)
@pytest.mark.parametrize("causal", [False, True])
def test_varlen_kernels_with_q_len_ne_kv_len(dev, dtype, D, causal):
    """Bottom-right causal alignment on each segment's own shift, negative
    (first rows see nothing) and positive."""
    starts, T = [0, 512, 768], 1280
    _varlen_check(dev, dtype, starts, (300, 1, 200), (200, 64, 449), T, 4, 2, D, seed=5,
                  causal=causal, softmax_scale=0.1, block_q=128, block_kv=256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("blocks", [(128, 64), (64, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("G", [1, 4])
def test_varlen_kernels_with_block_kv_64(dev, dtype, blocks, causal, G):
    """block_kv 64 at D 128: every 64-row kv tile of the 16-bit dk/dv kernel
    nests in one user block, and with starts aligned to 64 a 128-row tile
    would straddle two documents."""
    lens = (300, 1, 128, 77, 64)
    starts, T = _varlen_layout(lens, blocks)
    _varlen_check(dev, dtype, starts, lens, lens, T, 8, 8 // G, 128, seed=G + 2 * causal + 31,
                  causal=causal, softmax_scale=128 ** -0.5, block_q=blocks[0], block_kv=blocks[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_varlen_kernels_on_a_heavy_tailed_layout(dev, dtype, dropout_p):
    """One causal document of 4096 tokens among many of 64 (and one of 37):
    tiles whose loops differ by up to 64x, launched heaviest first."""
    lens = (64, 64, 64, 4096, 64, 64, 37, 64, 64, 64, 64, 64)
    starts, T = _varlen_layout(lens, (128, 128))
    drop = dict(dropout_p=dropout_p, dropout_seed=77) if dropout_p else {}
    _varlen_check(dev, dtype, starts, lens, lens, T, 8, 2, 128, seed=21, causal=True,
                  softmax_scale=0.088, block_q=128, block_kv=128, **drop)


BLOCKSPARSE_CASES = [
    # (block_q, block_kv, causal, mask over a 512-token segment)
    (128, 128, True, "random"),
    (256, 128, True, [[False, True, False, False], [True, True, True, False]]),   # rows with no kept causal column
    (128, 256, False, [[True, False], [False, False], [True, False], [True, False]]),  # a filtered row and kv block
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [128] + WIDE)
@pytest.mark.parametrize("case", range(len(BLOCKSPARSE_CASES)))
def test_blocksparse_kernels_match_plain(dev, dtype, D, case):
    import numpy as np
    from fa2_triton_tpu_torch.ops import varlen

    bq, bkv, causal, mask = BLOCKSPARSE_CASES[case]
    if mask == "random":
        mask = np.random.RandomState(0).rand(4, 4) < 0.6
    keep = varlen._mask_keep_fn(varlen.encode_block_mask(mask))
    starts, T = [0, 512], 1024
    _varlen_check(dev, dtype, starts, (512, 400), (512, 400), T, 8, 2, D, seed=case,
                  causal=causal, softmax_scale=0.09, block_q=bq, block_kv=bkv, keep_block=keep)


def _varlen_run(q, k, v, do, starts, lens, **kw):
    from fa2_triton_tpu_torch.ops import varlen

    o, lse = varlen.flash_attn_varlen_forward(q, k, v, starts, lens, lens, **kw)
    return (o, lse) + tuple(varlen.flash_attn_varlen_backward(q, k, v, do, o, lse, starts, lens,
                                                              lens, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE)
def test_varlen_kernels_ignore_nan_in_the_gaps(dev, dtype, D):
    """The gaps of the packed stream may hold NaN: every output equals that
    of zero gaps bit for bit, and dead positions are exactly 0."""
    lens = (300, 1, 128, 77)
    starts, T = _varlen_layout(lens, (128, 128))
    q, k, v, do = (x.to(dtype) for x in _varlen_inputs(dev, T, 8, 2, D, 3))
    live = _live_mask(starts, lens, T, dev)
    clean = [x.clone() for x in (q, k, v, do)]
    nan = [x.clone() for x in (q, k, v, do)]
    for c, n in zip(clean, nan):
        c[:, :, ~live] = 0
        n[:, :, ~live] = float("nan")
    kw = dict(causal=True, softmax_scale=0.088, block_q=128, block_kv=128)
    base = _varlen_run(*clean, starts, lens, **kw)
    got = _varlen_run(*nan, starts, lens, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, base):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [128] + WIDE)
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_varlen_kernels_are_bitwise_repeatable(dev, dtype, D, dropout_p):
    """Five runs of the forward (o, lse) and backward give equal bits (past
    D 256 each 32-row dk/dv block writes its own rows: still no atomics)."""
    lens = (300, 1, 128, 77)
    starts, T = _varlen_layout(lens, (128, 128))
    q, k, v, do = (x.to(dtype) for x in _varlen_inputs(dev, T, 8, 1, D, 4))
    kw = dict(causal=True, softmax_scale=0.088, block_q=128, block_kv=128,
              **(dict(dropout_p=dropout_p, dropout_seed=41) if dropout_p else {}))
    runs = [_varlen_run(q, k, v, do, starts, lens, **kw) for _ in range(5)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def test_varlen_public_api_grads_on_cuda_match_the_cpu(dev):
    """flash_attn_varlen_func and flash_attn_blocksparse_func on CUDA tensors
    that require grad (the kernels) against the same calls on the CPU (the
    plain twins), fp32, with an lse cotangent."""
    from fa2_triton_tpu_torch.ops import varlen

    rng = torch.Generator().manual_seed(0)
    lens = (200, 1, 128)
    starts, T = _varlen_layout(lens, (128, 128))
    cu = starts + [T]
    x = [torch.randn(T, h, 64, generator=rng) * 0.5 for h in (8, 2, 2)]
    do = torch.randn(T, 8, 64, generator=rng)
    dl = torch.randn(8, T, generator=rng)
    xb = [torch.randn(2, 256, h, 64, generator=rng) * 0.5 for h in (4, 4, 4)]
    dob = torch.randn(2, 256, 4, 64, generator=rng)
    mask = [[True, False], [False, True]]
    results = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_() for t in x]
        before = dict(varlen.LAUNCHES)
        out, lse = varlen.flash_attn_varlen_func(*leaves, cu, seqlens=lens, causal=True,
                                                 block_q=128, block_kv=128, return_lse=True)
        lse_term = torch.where(torch.isfinite(lse), lse, 0) * dl.to(device)
        ((out * do.to(device)).sum() + lse_term.sum()).backward()
        bleaves = [t.detach().to(device).requires_grad_() for t in xb]
        outb = varlen.flash_attn_blocksparse_func(*bleaves, mask, causal=True, block_q=128,
                                                  block_kv=128)
        (outb * dob.to(device)).sum().backward()
        launched = {n: varlen.LAUNCHES[n] - before[n] for n in before}
        assert set(launched.values()) == ({0} if device == "cpu" else {2}), launched
        results.append([t.detach().cpu() for t in (out, lse, outb)]
                       + [t.grad.cpu() for t in leaves + bleaves])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_varlen_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from fa2_triton_tpu_torch.ops import varlen

    x = torch.zeros(256, 2, 64, device=dev)
    with pytest.raises(ValueError, match="multiples of 64"):
        varlen.flash_attn_varlen_func(x, x, x, [0, 256], block_q=32, block_kv=32)
    x = torch.zeros(256, 2, 640, device=dev)
    with pytest.raises(ValueError, match="head_dim 640.*queue A"):
        varlen.flash_attn_varlen_func(x, x, x, [0, 256], block_q=128, block_kv=128)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        varlen.flash_attn_varlen_func(x[..., :64], x[..., :64], x[..., :64], [0, 256],
                                      dropout_p=0.1)


# ------------------------------------- quantized and paged decode (B5, B6) --

DECODE_LENS = [1, 2, 63, 64, 65, 700, 1000]
QDTYPE_IDS = {None: "none", torch.int8: "int8", torch.float8_e4m3fn: "fp8"}


def _stored_caches(k32, v32, qdtype, dtype):
    """The cache as the engine stores it: (k, v, k_scale, v_scale), scales
    in the [B, Hkv, 1, S] layout, or None for a cache in `dtype`."""
    if qdtype is None:
        return k32.to(dtype), v32.to(dtype), None, None
    from fa2_triton_tpu_torch.ops.quant import quantize_tensor

    (kq, ks), (vq, vs) = (quantize_tensor(x, qdtype) for x in (k32, v32))
    return kq, vq, ks.transpose(-1, -2).contiguous(), vs.transpose(-1, -2).contiguous()


def _to_pool(caches, lens, page, seed, fill=float("nan")):
    """Contiguous caches [B, Hkv, S, D] (+ scales [B, Hkv, 1, S]) -> a
    shuffled page pool and its tables. Page 0 is reserved and filled with
    `fill`; so are the rows past each slot's length, and table entries past
    its last live page point at page 0."""
    k, v, ks, vs = caches
    B, Hkv, S, D = k.shape
    M = S // page
    perm = torch.randperm(B * M, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros(B, M, dtype=torch.int32)
    empty = lambda shape, dtype: torch.full(shape, fill, device=k.device).to(dtype)
    pools = [empty((B * M + 1, Hkv, page, D), k.dtype), empty((B * M + 1, Hkv, page, D), v.dtype)]
    pools += [None if s is None else empty((B * M + 1, Hkv, 1, page), s.dtype) for s in (ks, vs)]
    for b, n in enumerate(lens):
        for i in range(-(-n // page)):
            p, r0, r1 = int(perm[b * M + i]), i * page, min((i + 1) * page, n)
            tables[b, i] = p
            for pool, x in zip(pools, caches):
                if x is None:
                    continue
                if x.shape[2] == 1:      # scales [B, Hkv, 1, S]
                    pool[p, :, :, :r1 - r0] = x[b, :, :, r0:r1]
                else:
                    pool[p, :, :r1 - r0] = x[b, :, r0:r1]
    return pools, tables.to(k.device)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("qdtype", list(QDTYPE_IDS), ids=list(QDTYPE_IDS.values()))
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("page", [128, 512])
@pytest.mark.parametrize("kw", [dict(), dict(window_left=300, softcap=3.0)])
def test_quant_and_paged_decode_kernels_match_plain(dev, dtype, qdtype, D, G, page, kw):
    """B5 quant vs its plain twin at matched bit-width (the plain twin
    dequantizes the same stored values: the bf16 rule), and B6 on a
    shuffled, NaN-padded pool equal to B5 on the same rows bit for bit."""
    g = torch.Generator(device=dev).manual_seed(D + G + page)
    B, Hkv, S_max = len(DECODE_LENS), 2, 1024
    q32 = torch.randn(B, Hkv * G, D, generator=g, device=dev) * 0.5
    k32 = torch.randn(B, Hkv, S_max, D, generator=g, device=dev) * 0.5
    v32 = torch.randn(B, Hkv, S_max, D, generator=g, device=dev) * 0.5
    kv_lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    caches = _stored_caches(k32, v32, qdtype, dtype)
    ref = decode.decode_attention_plain(q32, *(k32, v32) if qdtype is None else caches[:2], kv_lens,
                                        *caches[2:], **kw)
    q = q32.to(dtype)
    decode.reset_launches()
    o = decode.decode_attention(q, caches[0], caches[1], kv_lens, *caches[2:], **kw)
    torch.cuda.synchronize()
    _check(o, ref, decode.decode_attention_plain(q, *caches[:2], kv_lens, *caches[2:], **kw), dtype)
    pools, tables = _to_pool(caches, DECODE_LENS, page, seed=D + G)
    o_paged = decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens, *pools[2:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_paged, o)
    assert decode.LAUNCHES == 2
    assert decode.VARIANT_LAUNCHES == {decode.variant(False, caches[0].dtype): 1,
                                       decode.variant(True, caches[0].dtype): 1}


@pytest.mark.parametrize("qdtype", list(QDTYPE_IDS), ids=list(QDTYPE_IDS.values()))
def test_paged_decode_never_reads_dead_or_released_pages(dev, qdtype):
    """NaN in page 0 (the target of released entries behind the window and
    of entries past the last live page) and in rows past each length never
    reaches the output: it equals a run on a zero-filled pool bit for bit."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, Hkv, G, D, S_max, page = 3, 2, 4, 128, 1024, 128
    lens = [1000, 300, 5]
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev, dtype=torch.bfloat16)
    k32, v32 = (torch.randn(B, Hkv, S_max, D, generator=g, device=dev) for _ in range(2))
    caches = _stored_caches(k32, v32, qdtype, torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    outs = []
    for fill in (0.0, float("nan")):
        pools, tables = _to_pool(caches, lens, page, seed=3, fill=fill)
        # Release the pages behind the window (window_left 200): the first
        # read row of slot 0 is 799, so logical pages 0-5 point at page 0.
        tables[0, :6] = 0
        outs.append(decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens, *pools[2:],
                                                  window_left=200))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[1], outs[0])


def test_decode_wrappers_raise_on_what_the_quant_and_paged_kernels_do_not_take(dev):
    q = torch.zeros(2, 4, 128, device=dev, dtype=torch.bfloat16)
    cache8 = torch.zeros(2, 2, 256, 128, device=dev).to(torch.float8_e4m3fn)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    scale = torch.ones(2, 2, 1, 256, device=dev)
    with pytest.raises(ValueError, match="queue C"):
        decode.decode_attention(q, cache8, cache8, lens)
    with pytest.raises(ValueError, match="fp32"):
        decode.decode_attention(q, cache8, cache8, lens, scale.half(), scale)
    with pytest.raises(ValueError, match=r"\[2, 2, 1, 256\]"):
        decode.decode_attention(q, cache8, cache8, lens, scale.transpose(-1, -2).contiguous(), scale)
    pool = torch.zeros(5, 2, 128, 128, device=dev, dtype=torch.bfloat16)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        decode.paged_decode_attention(q, pool, pool, tables.long(), lens)
    with pytest.raises(ValueError, match="multiple of 128"):
        decode.paged_decode_attention(q, pool[:, :, :64].contiguous(), pool[:, :, :64].contiguous(),
                                      tables, lens)
    with pytest.raises(ValueError, match="is on"):
        decode.paged_decode_attention(q, pool, pool, tables.cpu(), lens)


def test_paged_engine_on_cuda_matches_engine_on_cpu(dev):
    from fa2_triton_tpu_torch.models import LlamaConfig, init_params
    from fa2_triton_tpu_torch.runtime import Engine

    cfg = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      hidden_dim=512, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = init_params(torch.Generator().manual_seed(0), cfg).to(dev)
    prompts = [[(7 * i + 3 * j) % 256 for j in range(n)] for i, n in enumerate((5, 40, 130))]
    outs = []
    for model in (cpu, gpu):
        decode.reset_launches()
        eng = Engine(model, cfg, n_slots=2, max_seq=512, paged=True, page_size=128)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        outs.append(reqs)
        assert decode.VARIANT_LAUNCHES == ({} if model is cpu else
                                           {"paged fp32": cfg.n_layers * eng.stats.decode_steps})
    for a, b in zip(*outs):
        assert a.out_tokens == b.out_tokens
        torch.testing.assert_close(torch.tensor(b.out_logprobs), torch.tensor(a.out_logprobs),
                                   rtol=0, atol=1e-3)



@pytest.mark.parametrize("kw", [dict(prefill_chunk=128),
                                dict(prefill_chunk=128, paged=True, page_size=128,
                                     prefix_cache=True)], ids=["chunked", "chunked-paged-prefix"])
def test_chunked_sampled_engine_on_cuda_matches_engine_on_cpu(dev, kw):
    """Chunked prefill (with the prefix cache when paged: the third prompt
    repeats the first's 256-token head) and a sampled request beside greedy
    ones: the card's tokens equal the CPU's, every chunk launches flash_fwd
    once per layer, and the prefix cache reuses the same pages."""
    from fa2_triton_tpu_torch.models import LlamaConfig, init_params
    from fa2_triton_tpu_torch.runtime import Engine, SamplingParams

    cfg = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      hidden_dim=512, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = init_params(torch.Generator().manual_seed(0), cfg).to(dev)
    head = [(5 * j + 1) % 256 for j in range(256)]
    prompts = [head + [7, 9], [(3 * j) % 256 for j in range(40)],
               head + [(11 * j) % 256 for j in range(90)]]
    samplings = [None, SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=2**31 + 1), None]
    outs = []
    for model in (cpu, gpu):
        flash_fwd.reset_launches()
        eng = Engine(model, cfg, n_slots=2, max_seq=512, **kw)
        reqs = [eng.submit(p, 6, sampling=sp) for p, sp in zip(prompts, samplings)]
        eng.run()
        outs.append((reqs, eng.stats))
        if model is gpu:
            assert flash_fwd.LAUNCHES == cfg.n_layers * eng.stats.prefill_dispatches
    (a, sa), (b, sb) = outs
    cached = 256 if kw.get("prefix_cache") else 0
    assert sb.prefix_cached_tokens == sa.prefix_cached_tokens == cached
    for x, y in zip(a, b):
        assert x.out_tokens == y.out_tokens
        torch.testing.assert_close(torch.tensor(y.out_logprobs), torch.tensor(x.out_logprobs),
                                   rtol=0, atol=1e-3)


def test_sampler_on_cuda_matches_cpu(dev):
    """The threefry bits on the card equal the CPU's bit for bit; the drawn
    tokens equal wherever the top-two gap of (adjusted logits + Gumbel
    noise) exceeds 1e-4."""
    from fa2_triton_tpu_torch.runtime import sampling

    B, V = 8, 32768
    seeds = torch.tensor([0, 1, 7, 123456, 2**31 - 1, 2**31, 2**32 - 1, 99])
    steps = torch.tensor([0, 1, 2, 17, 40000, 3, 2**31 - 1, 5])
    assert torch.equal(sampling.random_bits(seeds.to(dev), steps.to(dev), V).cpu(),
                       sampling.random_bits(seeds, steps, V))
    logits = torch.randn(B, V, generator=torch.Generator().manual_seed(1)) * 3
    samp = ([0.0, 0.8, 1.0, 0.7, 5.0, 1.0, 0.3, 2.0], [0, 50, 0, 0, 1, 20, 0, 0],
            [1.0, 0.95, 0.9, 1.0, 1.0, 0.5, 1.0, 0.99], seeds, steps)
    cpu = sampling.sample_tokens(logits, *samp)
    card = sampling.sample_tokens(logits.to(dev), *samp).cpu()
    noisy = sampling.adjust_logits(logits, *samp[:3]) + sampling._gumbel(seeds, steps, V)
    top2 = noisy.topk(2, dim=-1).values
    held = torch.isinf(top2[:, 1]) | (top2[:, 0] - top2[:, 1] > 1e-4)
    assert int(held.sum()) >= B - 1
    assert torch.equal(cpu[held], card[held])

# ----------------------------- split-KV decode (B5, B6) -----------------------------
# The kernel cuts each (slot, KV head) into chunks of decode.CHUNK logical rows
# on a grid sized from shapes alone; the last block of a slot's live chunks
# merges their partials in chunk order.

SPLIT_S_MAX = 4096


def _split_lens(chunk):
    """kv lengths around the chunk edges, and the whole cap (S_max 4096 is 8
    or more chunks), and a slot with no key."""
    return [chunk - 1, chunk, chunk + 1, 2 * chunk + 77, SPLIT_S_MAX, 0]


@pytest.mark.parametrize("dtype,qdtype", [(torch.float32, None), (torch.bfloat16, None),
                                          (torch.float16, None), (torch.bfloat16, torch.int8),
                                          (torch.float16, torch.float8_e4m3fn)],
                         ids=["fp32", "bf16", "fp16", "bf16-int8", "fp16-fp8"])
@pytest.mark.parametrize("kw", [dict(), dict(window_left=300), dict(window_left=1000),
                                dict(softcap=3.0)],
                         ids=["full", "window-mid-chunk", "window-empty-leading-chunks", "softcap"])
def test_split_kv_decode_matches_plain(dev, dtype, qdtype, kw):
    """Lengths at chunk - 1, chunk, chunk + 1 and the cap, kv_len 0, a
    window whose first row falls mid-chunk and one that leaves whole leading
    chunks empty: each against the plain twin (kv_len 0 gives o = 0), and
    paged (page 128) equal to contiguous bit for bit."""
    chunk = decode.CHUNK
    assert decode.chunk_count(SPLIT_S_MAX) == SPLIT_S_MAX // chunk >= 8
    lens = _split_lens(chunk)
    g = torch.Generator(device=dev).manual_seed(chunk + len(kw))
    B, Hkv, G, D = len(lens), 2, 4, 128
    q32 = torch.randn(B, Hkv * G, D, generator=g, device=dev) * 0.5
    k32, v32 = (torch.randn(B, Hkv, SPLIT_S_MAX, D, generator=g, device=dev) * 0.5
                for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    caches = _stored_caches(k32, v32, qdtype, dtype)
    ref = decode.decode_attention_plain(q32, *(k32, v32) if qdtype is None else caches[:2], kv_lens,
                                        *caches[2:], **kw)
    q = q32.to(dtype)
    o = decode.decode_attention(q, caches[0], caches[1], kv_lens, *caches[2:], **kw)
    torch.cuda.synchronize()
    _check(o, ref, decode.decode_attention_plain(q, *caches[:2], kv_lens, *caches[2:], **kw), dtype)
    assert not o[lens.index(0)].any()
    pools, tables = _to_pool(caches, lens, 128, seed=chunk)
    o_paged = decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens, *pools[2:],
                                            **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_paged, o)


def _longer_tables(tables, extra):
    """Tables with `extra` more entries per slot, each at the reserved page 0
    (NaN there): the pool's cap grows to (max_pages + extra) x page."""
    pad = torch.zeros(tables.shape[0], extra, dtype=torch.int32, device=tables.device)
    return torch.cat([tables, pad], dim=1).contiguous()


@pytest.mark.parametrize("qdtype", list(QDTYPE_IDS), ids=list(QDTYPE_IDS.values()))
@pytest.mark.parametrize("page", [128, 512])
def test_paged_decode_equals_contiguous_when_the_pool_is_longer_than_s_max(dev, qdtype, page):
    """max_pages x page > S_max: the pool's cap has more chunks than the
    contiguous cache's, all past every slot's length, and paged still equals
    contiguous bit for bit (a window included)."""
    g = torch.Generator(device=dev).manual_seed(page)
    lens = _split_lens(decode.CHUNK)
    B, Hkv, G, D = len(lens), 2, 8, 128
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(torch.bfloat16)
    k32, v32 = (torch.randn(B, Hkv, SPLIT_S_MAX, D, generator=g, device=dev) for _ in range(2))
    caches = _stored_caches(k32, v32, qdtype, torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    pools, tables = _to_pool(caches, lens, page, seed=page)
    longer = _longer_tables(tables, extra=3 * 1024 // page)
    assert decode.chunk_count(longer.shape[1] * page) > decode.chunk_count(SPLIT_S_MAX)
    for kw in (dict(), dict(window_left=700)):
        o = decode.decode_attention(q, caches[0], caches[1], kv_lens, *caches[2:], **kw)
        o_paged = decode.paged_decode_attention(q, pools[0], pools[1], longer, kv_lens, *pools[2:],
                                                **kw)
        torch.cuda.synchronize()
        assert torch.equal(o_paged, o), kw


@pytest.mark.parametrize("dtype,qdtype", [(torch.float32, None), (torch.bfloat16, None),
                                          (torch.bfloat16, torch.int8),
                                          (torch.float16, torch.float8_e4m3fn)],
                         ids=["fp32", "bf16", "bf16-int8", "fp16-fp8"])
def test_split_kv_decode_is_bitwise_repeatable(dev, dtype, qdtype):
    """Five runs of one call, contiguous and paged, equal bit for bit: the
    chunks' partials merge in chunk order whichever block arrives last."""
    g = torch.Generator(device=dev).manual_seed(3)
    lens = [4096, 3000, 1, 2048, 513, 4000, 17, 1024]
    B, Hkv, G, D = len(lens), 8, 4, 128
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dtype)
    k32, v32 = (torch.randn(B, Hkv, SPLIT_S_MAX, D, generator=g, device=dev) for _ in range(2))
    caches = _stored_caches(k32, v32, qdtype, dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    pools, tables = _to_pool(caches, lens, 512, seed=5)
    runs = [(decode.decode_attention(q, caches[0], caches[1], kv_lens, *caches[2:]),
             decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens, *pools[2:]))
            for _ in range(5)]
    torch.cuda.synchronize()
    bits = lambda x: x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)  # noqa: E731
    for o, o_paged in runs:
        assert torch.equal(bits(o), bits(runs[0][0]))
        assert torch.equal(bits(o_paged), bits(runs[0][0]))


@pytest.mark.parametrize("qdtype", list(QDTYPE_IDS), ids=list(QDTYPE_IDS.values()))
def test_split_kv_decode_ignores_nan_in_every_unused_row_page_and_table_entry(dev, qdtype):
    """NaN (-128 in an int8 cache) in every row outside [first, kv_len) of
    the contiguous cache, in every page no live row uses (page 0 included),
    and table entries that no live row needs (behind the window, past the
    last live page) set to an index far past the pool: the output equals a
    clean run bit for bit."""
    g = torch.Generator(device=dev).manual_seed(9)
    lens, wl, page = [4096, 1000, 300, 1, 0], 700, 128
    B, Hkv, G, D = len(lens), 2, 4, 128
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(torch.bfloat16)
    k32, v32 = (torch.randn(B, Hkv, SPLIT_S_MAX, D, generator=g, device=dev) for _ in range(2))
    caches = _stored_caches(k32, v32, qdtype, torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    base = decode.decode_attention(q, caches[0], caches[1], kv_lens, *caches[2:], window_left=wl)
    dirty = [None if x is None else x.clone() for x in caches]
    for b, n in enumerate(lens):
        first = max(0, n - 1 - wl)
        for x in dirty:
            junk = -128 if x is not None and x.dtype == torch.int8 else float("nan")
            if x is not None and x.shape[2] == 1:
                x[b, :, :, :first] = junk
                x[b, :, :, n:] = junk
            elif x is not None:
                x[b, :, :first] = junk
                x[b, :, n:] = junk
    o = decode.decode_attention(q, dirty[0], dirty[1], kv_lens, *dirty[2:], window_left=wl)
    pools, tables = _to_pool(caches, lens, page, seed=4)          # unused pages: NaN
    for b, n in enumerate(lens):
        first = max(0, n - 1 - wl)
        live = set(range(first // page, -(-n // page))) if n > first else set()
        for i in range(tables.shape[1]):
            if i not in live:
                tables[b, i] = 2 ** 30                             # far past the pool
    o_paged = decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens, *pools[2:],
                                            window_left=wl)
    torch.cuda.synchronize()
    assert torch.isfinite(base).all()
    assert torch.equal(o, base)
    assert torch.equal(o_paged, base)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn], ids=["int8", "fp8"])
def test_decode_widens_every_8bit_value_exactly(dev, dtype, qdtype):
    """The tensor-core path widens 8-bit rows to 16 bits by bit operations:
    with one key and a v scale of 1, o is the stored V row itself, so every
    int8 value and every finite e4m3 value (subnormals too) must come out
    exactly."""
    D = 256
    codes = torch.arange(256, dtype=torch.int32)
    if qdtype == torch.float8_e4m3fn:
        codes = torch.where((codes & 0x7F) == 0x7F, torch.zeros_like(codes), codes)  # NaN codes
    row = codes.to(torch.uint8).view(torch.int8).view(qdtype)
    v = row.view(1, 1, 1, D).to(dev).contiguous()
    k = torch.zeros_like(v)
    scale = torch.ones(1, 1, 1, 1, device=dev)
    q = torch.zeros(1, 1, D, device=dev, dtype=dtype)
    kv_lens = torch.ones(1, dtype=torch.int32, device=dev)
    o = decode.decode_attention(q, k, v, kv_lens, scale, scale)
    torch.cuda.synchronize()
    want = row.float().to(dtype).to(dev)
    assert torch.equal(o.view(D), want)

# ------------------------- dropout (B1, B7/B8 dropout) -------------------------

DROPOUT_CASES = [
    dict(),                                                   # padded causal
    dict(window=(17, 0)),
    dict(softcap=4.0),
    dict(bias=True),                                          # dq / dk/dv with a bias, and dbias
    dict(q_off=40, sq=60, sk=100),                            # a chunk at a global offset
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDER)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("case", range(len(DROPOUT_CASES)))
def test_dropout_kernels_match_plain(dev, dtype, D, G, case):
    """Forward, dq, dk/dv (and dbias) with dropout against the plain twins
    fed the same seed (FA rules); the chunk case sits at q_off 40 with real
    lengths past the call, so the counter uses seqlen_*_real. Past D 512 the
    bias case takes no gradient (dbias is not built there yet)."""
    c = dict(DROPOUT_CASES[case])
    with_bias = c.pop("bias", False)
    with_dbias = with_bias and D <= flash_fwd.MAX_HEAD_DIM
    (q32, k32, v32, do32), lens, q_off, kw = _bwd_inputs(dev, dict(c, hkv=8 // G), D,
                                                         case * 13 + D + G)
    kw.update(dropout_p=0.17, dropout_seed=(case - 2) * 1000 + D + G)
    if "q_off" in c:
        kw.update(seqlen_q_real=q_off + q32.shape[2] + 5, seqlen_k_real=k32.shape[2] + 9)
    b32 = None
    if with_bias:
        b32 = torch.randn(1, 8, q32.shape[2], k32.shape[2],
                          generator=torch.Generator(device=dev).manual_seed(D), device=dev)
    dbias = dict(compute_dbias=with_dbias)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, q_off, 0, b32, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, q_off, 0, b32,
                                               **dbias, **kw)
    q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
    bias = None if b32 is None else b32.to(dtype)
    fwd0, bwd0 = flash_fwd.LAUNCHES, dict(flash_bwd.LAUNCHES)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, q_off, 0, bias, **kw)
    grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, q_off, 0, bias, **dbias, **kw)
    launched = (flash_fwd.LAUNCHES - fwd0,
                *(flash_bwd.LAUNCHES[n] - bwd0[n] for n in sorted(bwd0)))
    assert launched == (1, int(with_dbias), 1, 1), launched     # fwd, dbias, dq, dk/dv
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(q, k, v, lens, q_off, 0, bias, **kw)
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, q_off, 0, bias,
                                                 **dbias, **kw)
    torch.cuda.synchronize()
    _check(o, o32, o_pl, dtype)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_pl))
    fin = torch.isfinite(lse_pl)
    assert (lse[fin] - lse_pl[fin]).abs().max().item() <= 1e-4
    _check_grads(grads, refs, plains, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4])
def test_dropout_mask_probes_are_bitwise_the_rng_mask(dev, dtype, D, G):
    """Each kernel's applied mask, read by `utils/mask_probes.py`, equals the
    rng mask bit for bit: dense at q_off 37 / kv_off 11 with real lengths
    500 x 700, and packed documents at nonzero packed offsets."""
    from fa2_triton_tpu_torch.utils import mask_probes

    seed = -(D * 7 + G)
    got = mask_probes.dense_probes(2, 8, 8 // G, D, 0.3, seed, device=dev, dtype=dtype, q_off=37,
                                   kv_off=11, rows=96, seqlen_q_real=500, seqlen_k_real=700)
    got.update(mask_probes.packed_probes(8, 8 // G, D, 0.3, seed, device=dev, dtype=dtype))
    torch.cuda.synchronize()
    for name, (read, want, resid) in got.items():
        assert torch.equal(read, want), (name, (read != want).sum().item())
        assert resid <= mask_probes.RESIDUAL_TOL, (name, resid)


def test_dropout_kernels_are_deterministic_in_the_seed(dev):
    """The same seed gives bitwise-equal o / dq / dk / dv, seed + 1 others."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = [(torch.randn(2, 300, h, 128, generator=g, device=dev) * 0.5).to(torch.bfloat16)
         for h in (8, 2, 2)]
    do = torch.randn(2, 300, 8, 128, generator=g, device=dev).to(torch.bfloat16)

    def run(seed):
        leaves = [t.detach().requires_grad_() for t in x]
        out = flash_attn_func(*leaves, causal=True, dropout_p=0.1, dropout_seed=seed)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    a, a2, b = run(5), run(5), run(6)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(a, a2))
    assert not any(torch.equal(u, w) for u, w in zip(a, b))


def test_dropout_on_cuda_launches_the_kernels(dev):
    """flash_attn_func and flash_attn_varlen_func with dropout on CUDA
    tensors that require grad launch every kernel once (no plain twin stands
    in), and their gradients match the same calls on the CPU, fp32. The
    dense call's backward is the tri-square (B13): JAX pads S 150 / D 64 in
    fp32 to S 256 / D 128, inside its gate for a GQA group of 4, so it takes
    that route as JAX does and the dq / dk/dv pair stays at 0."""
    from fa2_triton_tpu_torch.ops import varlen

    rng = torch.Generator().manual_seed(3)
    x = [torch.randn(2, 150, h, 64, generator=rng) * 0.5 for h in (8, 2, 2)]
    do = torch.randn(2, 150, 8, 64, generator=rng)
    lens = (200, 1, 128)
    starts, T = _varlen_layout(lens, (128, 128))
    xv = [torch.randn(T, h, 64, generator=rng) * 0.5 for h in (8, 2, 2)]
    dov = torch.randn(T, 8, 64, generator=rng)
    results = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_() for t in x + xv]
        fwd0, bwd0, var0 = flash_fwd.LAUNCHES, dict(flash_bwd.LAUNCHES), dict(varlen.LAUNCHES)
        tri0 = flash_bwd.SCHEDULE_LAUNCHES["tri_square"]
        out = flash_attn_func(*leaves[:3], causal=True, dropout_p=0.2, dropout_seed=-11)
        (out * do.to(device)).sum().backward()
        outv = varlen.flash_attn_varlen_func(*leaves[3:], starts + [T], seqlens=lens, causal=True,
                                             block_q=128, block_kv=128, dropout_p=0.2,
                                             dropout_seed=12)
        (outv * dov.to(device)).sum().backward()
        launched = (flash_fwd.LAUNCHES - fwd0, flash_bwd.LAUNCHES["flash_bwd_dq"] - bwd0["flash_bwd_dq"],
                    flash_bwd.LAUNCHES["flash_bwd_dkdv"] - bwd0["flash_bwd_dkdv"],
                    flash_bwd.SCHEDULE_LAUNCHES["tri_square"] - tri0,
                    *(varlen.LAUNCHES[n] - var0[n] for n in sorted(var0)))
        assert launched == ((0,) * 7 if device == "cpu" else (1, 0, 0, 1, 1, 1, 1)), launched
        results.append([out.detach().cpu(), outv.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE)
@pytest.mark.parametrize("G", [1, 4])
def test_varlen_dropout_kernels_match_plain(dev, dtype, D, G):
    lens = (300, 1, 128, 77)
    blocks = VARLEN_BLOCKS[D]
    starts, T = _varlen_layout(lens, blocks)
    _varlen_check(dev, dtype, starts, lens, lens, T, 8, 8 // G, D, seed=D + G + 1,
                  causal=True, softmax_scale=D ** -0.5, block_q=blocks[0], block_kv=blocks[1],
                  dropout_p=0.2, dropout_seed=D - 3 * G)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE)
@pytest.mark.parametrize("G", [1, 4])
def test_varlen_forward_drops_what_the_fma_kernel_drops(dev, dtype, D, G):
    """At p 0.1 the 16-bit forward (tensor cores) drops the same elements
    as the fp32 one (FMA tiles): the mask probe reads both bit for bit, and
    both equal the rng mask (past D 256 a row's hash follows its row group
    of 16, two warps each)."""
    from fa2_triton_tpu_torch.utils import mask_probes

    seed = 1234 + D + G
    fma = mask_probes.packed_probes(8, 8 // G, D, 0.1, seed, device=dev, dtype=torch.float32)
    mma = mask_probes.packed_probes(8, 8 // G, D, 0.1, seed, device=dev, dtype=dtype)
    torch.cuda.synchronize()
    (read_fma, want, _), (read_mma, _, resid) = fma["varlen_fwd"], mma["varlen_fwd"]
    assert torch.equal(read_mma, read_fma), (read_mma != read_fma).sum().item()
    assert torch.equal(read_mma, want) and resid <= mask_probes.RESIDUAL_TOL, resid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [128] + WIDE)
def test_blocksparse_dropout_kernels_match_plain(dev, dtype, D):
    import numpy as np
    from fa2_triton_tpu_torch.ops import varlen

    keep = varlen._mask_keep_fn(varlen.encode_block_mask(np.random.RandomState(0).rand(4, 4) < 0.6))
    _varlen_check(dev, dtype, [0, 512], (512, 400), (512, 400), 1024, 8, 2, D, seed=9,
                  causal=True, softmax_scale=0.09, block_q=128, block_kv=128, keep_block=keep,
                  dropout_p=0.3, dropout_seed=-1)


@pytest.mark.parametrize("D", [32, 96, 160, 300, 448])
def test_head_dims_off_the_kernel_widths_are_padded(dev, D):
    """flash_attn_func, flash_attn_varlen_func and flash_attn_blocksparse_func
    take any head_dim <= 512 on CUDA (zero-padded to 64 / 128 / 256 / 384 /
    512 for the kernels): outputs and gradients match the same calls on the
    CPU, fp32."""
    from fa2_triton_tpu_torch.ops import varlen

    rng = torch.Generator().manual_seed(D)
    x = [torch.randn(2, 130, h, D, generator=rng) * 0.5 for h in (4, 2, 2)]
    xv = [torch.randn(256, h, D, generator=rng) * 0.5 for h in (4, 2, 2)]
    results = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_() for t in x + xv]
        outs = [flash_attn_func(*leaves[:3], causal=True, dropout_p=0.1, dropout_seed=D),
                varlen.flash_attn_varlen_func(*leaves[3:], [0, 128, 256], seqlens=[100, 77],
                                              causal=True, block_q=128, block_kv=128),
                varlen.flash_attn_blocksparse_func(*leaves[:3], [[True, False], [True, True]],
                                                   causal=True, block_q=128, block_kv=128)]
        sum(o.float().square().sum() for o in outs).backward()
        assert all(o.shape[-1] == D for o in outs)
        results.append([o.detach().cpu() for o in outs] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


# ------------- causal forward schedules (B10, B9 diag, B11, B1 merge) -------------

# Each case: (Sq, Sk, lens, the call). S 300 with leaves of 128: the last leaf
# is short, batch row 1 has a dead tail past 211 rows; the shifted strip has
# Sk - Sq = 128. The rectangle is the split's first: rows [128, 300) against
# columns [0, 128). The unaligned one starts inside a 64-row q tile and a
# key tile, rows [100, 250) against columns [36, 136); the ragged diag's
# second leaf of 192 holds 108 rows.
RECT = dict(row0=128, col0=0, nrows=256, ncols=128)
RECT_UNALIGNED = dict(row0=100, col0=36, nrows=150, ncols=100)
SCHEDULE_CASES = {
    "strip": (300, 300, [[300, 300], [211, 211]],
              lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_causal_strip(q, k, v, lens, **kw)),
    "strip_shifted": (172, 300, [[172, 300]] * 2,
                      lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_causal_strip(q, k, v, lens, **kw)),
    "diag": (300, 300, [[300, 300], [211, 211]],
             lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_causal_diag(q, k, v, lens, T=128, **kw)),
    "rect": (300, 300, [[300, 300], [211, 211]],
             lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_rect(q, k, v, lens, **RECT, **kw)),
    "rect_merge": (300, 300, [[300, 300], [211, 211]],
                   lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_rect(
                       q, k, v, lens, **RECT, merge_prev=prev, **kw)),
    "rect_unaligned": (300, 300, [[300, 300], [211, 211]],
                       lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_rect(
                           q, k, v, lens, **RECT_UNALIGNED, **kw)),
    "rect_merge_unaligned": (300, 300, [[300, 300], [211, 211]],
                             lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_rect(
                                 q, k, v, lens, **RECT_UNALIGNED, merge_prev=prev, **kw)),
    "diag_ragged": (300, 300, [[300, 300], [211, 211]],
                    lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward_causal_diag(
                        q, k, v, lens, T=192, **kw)),
    "split": (300, 300, [[300, 300], [211, 211]],
              lambda f, q, k, v, lens, prev, **kw: f.flash_attn_forward(
                  q, k, v, lens, causal=True, static_skip=True, tri_square=False, causal_split=True,
                  split_leaf=128, **kw)),
}
SCHEDULE_LAUNCH_DELTAS = {
    "strip": {"causal_strip": 1}, "strip_shifted": {"causal_strip": 1},
    "diag": {"causal_diag": 1}, "rect": {"rect": 1}, "rect_merge": {"rect_merge": 1},
    "rect_unaligned": {"rect": 1}, "rect_merge_unaligned": {"rect_merge": 1},
    "diag_ragged": {"causal_diag": 1},
    "split": {"causal_diag": 1, "rect_merge": 2},   # three leaves: causal_split_rects(3)
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
def test_schedule_kernels_match_plain(dev, dtype, D, case, dropout_p):
    """Each schedule kernel against its plain twin (the same entry point on
    CPU copies): fp32 1e-4, fp16 / bf16 the FA rule against the fp32 plain;
    lse 1e-4 with the same -inf pattern; the launches each call makes, and
    none of csrc/flash_fwd.cu. The merge starts from the diag kernel's
    (o, lse), copied to each side."""
    Sq, Sk, lens, call = SCHEDULE_CASES[case]
    want = SCHEDULE_LAUNCH_DELTAS[case]
    if case == "split" and D > 256:
        # JAX's gate refuses S 300 past D 256 (its blocks pad q and kv to
        # different lengths there): the split runs at S 512, four leaves.
        Sq = Sk = 512
        lens, want = [[512, 512], [423, 423]], {"causal_diag": 1, "rect_merge": 3}
    g = torch.Generator(device=dev).manual_seed(D + len(case))
    x32 = [(torch.randn(2, s, h, D, generator=g, device=dev) * 0.5).transpose(1, 2)
           for s, h in ((Sq, 4), (Sk, 2), (Sk, 2))]
    lens = torch.tensor(lens, dtype=torch.int32)
    kw = dict(softmax_scale=D ** -0.5, dropout_p=dropout_p, dropout_seed=D - 7 * len(case))
    x = [t.to(dtype) for t in x32]
    prev = prev32 = prev_lp = None
    if case.startswith("rect_merge"):
        prev = flash_fwd.flash_attn_forward_causal_diag(*x, lens.to(dev), T=128, **kw)
        prev32 = (prev[0].float().cpu(), prev[1].cpu())
        prev_lp = tuple(t.cpu() for t in prev)
    ref = call(flash_fwd, *(t.cpu() for t in x32), lens, prev32, **kw)
    plain = call(flash_fwd, *(t.cpu() for t in x), lens, prev_lp, **kw)
    before, fwd0 = dict(flash_fwd.SCHEDULE_LAUNCHES), flash_fwd.LAUNCHES
    o, lse = call(flash_fwd, *x, lens.to(dev), prev, **kw)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in flash_fwd.SCHEDULE_LAUNCHES.items() if c != before[n]}
    assert delta == want and flash_fwd.LAUNCHES == fwd0, delta
    assert o.shape == plain[0].shape and o.dtype == dtype
    _check(o.cpu(), ref[0], plain[0], dtype)
    lse, lse_pl = lse.cpu(), plain[1]
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_pl))
    fin = torch.isfinite(lse_pl)
    assert (lse[fin] - lse_pl[fin]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("Sq,Sk", [(300, 300), (172, 300), (700, 700)])
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
def test_strip_equals_the_generic_kernel_bit_for_bit(dev, dtype, D, Sq, Sk, dropout_p):
    """The strip keeps flash_fwd.cu's tile order and arithmetic and only
    drops the mask test below the diagonal: o and lse are equal bit for bit,
    dead rows included."""
    g = torch.Generator(device=dev).manual_seed(D + Sq)
    q, k, v = ((torch.randn(2, s, h, D, generator=g, device=dev) * 0.5).to(dtype).transpose(1, 2)
               for s, h in ((Sq, 4), (Sk, 2), (Sk, 2)))
    lens = torch.tensor([[Sq, Sk], [Sq - 57, Sk - 57]], dtype=torch.int32, device=dev)
    kw = dict(softmax_scale=D ** -0.5, dropout_p=dropout_p, dropout_seed=Sq)
    o_s, lse_s = flash_fwd.flash_attn_forward_causal_strip(q, k, v, lens, **kw)
    o_g, lse_g = flash_fwd.flash_attn_forward(q, k, v, lens, causal=True, **kw)
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(o_s.contiguous().view(bits), o_g.contiguous().view(bits))
    assert torch.equal(lse_s.view(torch.int32), lse_g.view(torch.int32))


# The split's calls reduce to the generic kernel's: a diag whose leaf holds
# the whole call (T >= Sq) is its causal call, a rectangle over every row and
# column its non-causal call.
SPLIT_AS_GENERIC = {
    "diag": (lambda q, k, v, lens, **kw: flash_fwd.flash_attn_forward_causal_diag(
        q, k, v, lens, T=320, **kw), True),
    "rect": (lambda q, k, v, lens, **kw: flash_fwd.flash_attn_forward_rect(
        q, k, v, lens, row0=0, col0=0, nrows=q.shape[2], ncols=k.shape[2], **kw), False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE + WIDER)
@pytest.mark.parametrize("call", list(SPLIT_AS_GENERIC))
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
def test_split_calls_equal_the_generic_kernel_bit_for_bit(dev, dtype, D, call, dropout_p):
    """The diag and the rectangle are calls of flash_fwd.cu's kernels: cut
    to the whole problem, their o and lse equal the generic call's bit for
    bit, dead rows included (S 300, a ragged last tile, batch row 1 dead past
    211 rows)."""
    run, causal = SPLIT_AS_GENERIC[call]
    g = torch.Generator(device=dev).manual_seed(D + len(call))
    q, k, v = ((torch.randn(2, 300, h, D, generator=g, device=dev) * 0.5).to(dtype).transpose(1, 2)
               for h in (4, 2, 2))
    lens = torch.tensor([[300, 300], [211, 211]], dtype=torch.int32, device=dev)
    kw = dict(softmax_scale=D ** -0.5, dropout_p=dropout_p, dropout_seed=D + 11)
    o_s, lse_s = run(q, k, v, lens, **kw)
    o_g, lse_g = flash_fwd.flash_attn_forward(q, k, v, lens, causal=causal, **kw)
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(o_s.contiguous().view(bits), o_g.contiguous().view(bits))
    assert torch.equal(lse_s.view(torch.int32), lse_g.view(torch.int32))


@pytest.mark.parametrize("D,S,route", [(64, 2560, "strip"), (128, 4095, "split"),
                                       (256, 2048, "split")])
def test_flash_attn_func_routes_long_causal_calls(dev, prior_routes, D, S, route):
    """The public call, bf16, B 1, 4 / 2 heads: D 64 at S 2560 takes the
    strip, D 128 at S 4095 and D 256 at S 2048 (split_leaf_t 1024) the split;
    the launches follow, the generic forward launches none, and output and
    gradients (dq / dk/dv kernels on the schedule's o and lse) meet the FA
    rules against the fp32 plain twins."""
    from fa2_triton_tpu_torch.ops import flash_bwd

    assert flash_fwd.forward_route(S, S, D, 2, causal=True, static_skip=True) == route
    g = torch.Generator(device=dev).manual_seed(D)
    x32 = [torch.randn(1, S, h, D, generator=g, device=dev) * 0.5 for h in (4, 2, 2)]
    do32 = torch.randn(1, S, 4, D, generator=g, device=dev)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in x32]
    before, fwd0, bwd0 = dict(flash_fwd.SCHEDULE_LAUNCHES), flash_fwd.LAUNCHES, dict(flash_bwd.LAUNCHES)
    out, lse = flash_attn_func(*leaves, causal=True, return_lse=True)
    out.backward(do32.to(torch.bfloat16))
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in flash_fwd.SCHEDULE_LAUNCHES.items() if c != before[n]}
    want = {"causal_strip": 1} if route == "strip" else {"causal_diag": 1, "rect_merge": 1}
    assert delta == want and flash_fwd.LAUNCHES == fwd0, delta
    assert {n: flash_bwd.LAUNCHES[n] - bwd0[n] for n in bwd0} == {
        "flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}
    t = lambda x: x.transpose(1, 2)
    lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
    q, k, v = (t(x.detach()) for x in leaves)
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw)
    _check(t(out), o32, o_pl, torch.bfloat16)
    assert (lse - lse_pl).abs().max().item() <= 1e-4
    refs = flash_bwd.flash_attn_backward_plain(*(t(x) for x in x32), t(do32), o32, lse32, lens,
                                               **kw)
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, t(do32.to(torch.bfloat16)),
                                                 t(out.detach()), lse.detach(), lens, **kw)
    _check_grads([t(x.grad) for x in leaves], refs, plains, torch.bfloat16)


# ------- causal backward schedules (B13 tri-square, diag, rect; B14 work list) -------

def _sched_bwd_inputs(dev, D, Hkv, seed, S=300):
    """B 2 x S, Hq 8, D; batch row 1 has a dead tail past S - 89 rows. The
    forward's (o, lse) come from the plain twin in fp32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x32 = [(torch.randn(2, S, h, D, generator=g, device=dev) * 0.5).transpose(1, 2)
           for h in (8, Hkv, Hkv)]
    do32 = torch.randn(2, S, 8, D, generator=g, device=dev).transpose(1, 2)
    dl32 = torch.randn(2, 8, S, generator=g, device=dev) * 0.1
    lens = torch.tensor([[S, S], [S - 89, S - 89]], dtype=torch.int32, device=dev)
    return x32, do32, dl32, lens


# Each case: (Hkv, the call as f(flash_bwd, q, k, v, do, o, lse, lens, dlse, **kw), the
# SCHEDULE_LAUNCHES it adds). The diag and the rect take k prescaled and the
# global delta, as the split hands them over; the split is called directly (at
# these lengths flash_attn_backward's routing takes the tri-square first).
def _tri(f, q, k, v, do, o, lse, lens, dl, **kw):
    return f.flash_attn_backward_tri_square(q, k, v, do, o, lse, lens, dlse=dl, **kw)


def _diag(f, q, k, v, do, o, lse, lens, dl, T=128, **kw):
    k_p, delta = f._prescale_k(k, kw["softmax_scale"]), f.compute_delta(o, do, lse, dl)
    return f.flash_attn_backward_causal_diag(q, k_p, v, do, lse, delta, lens, T=T, **kw)


def _diag_leaves(T):
    def run(f, *args, **kw):
        return _diag(f, *args, T=T, **kw)
    return run


def _rect(f, q, k, v, do, o, lse, lens, dl, **kw):
    k_p, delta = f._prescale_k(k, kw["softmax_scale"]), f.compute_delta(o, do, lse, dl)
    return f.flash_attn_backward_rect(q, k_p, v, do, lse, delta, lens, row0=128, col0=0,
                                      nrows=256, ncols=128, **kw)


def _split(f, q, k, v, do, o, lse, lens, dl, **kw):
    return f._causal_split_backward(q, k, v, do, o, lse, lens, dlse=dl, leaf_t=128, **kw)


def _worklist(**extra):
    def run(f, q, k, v, do, o, lse, lens, dl, **kw):
        return f.flash_attn_backward_fused_wl(q, k, v, do, o, lse, lens, dlse=dl, **extra, **kw)
    return run


# A fourth entry is the sequence length (default 300). At S 1000 the 16-bit
# kernels' partitions give several blocks per (leaf, kv head, batch row) or
# per strip, with a ragged last kv tile, leaf or chunk.
SCHED_BWD_CASES = {
    "tri_square": (8, _tri, {"tri_square": 1}),
    "tri_square_parts": (2, _tri, {"tri_square": 1}, 1000),
    "diag_ragged_leaf": (2, _diag_leaves(384), {"causal_diag": 1}, 1000),   # leaves 384 / 384 / 232
    "worklist_chunks": (8, _worklist(sub=128, block_kv=256), {"worklist": 1}, 1000),
    "tri_square_gqa": (2, _tri, {"tri_square": 1}),
    "diag": (2, _diag, {"causal_diag": 1}),
    "rect": (2, _rect, {"rect": 1}),
    "split": (2, _split, {"causal_diag": 1, "rect": 2}),     # three leaves: causal_split_rects(3)
    "worklist": (8, _worklist(sub=128), {"worklist": 1}),    # one strip: the fold in the kernel
    "worklist_gqa": (2, _worklist(sub=64), {"worklist": 1}),
    "worklist_strips": (8, _worklist(sub=64, block_kv=128), {"worklist": 1}),   # three strips
    "worklist_window": (8, _worklist(sub=64, block_kv=128, window=(100, -1)), {"worklist": 1}),
}


def _sched_bwd_run(case, dev, dtype, D, dropout_p):
    Hkv, call, _, *S = SCHED_BWD_CASES[case]
    x32, do32, dl32, lens = _sched_bwd_inputs(dev, D, Hkv, D + len(case), *S)
    kw = dict(softmax_scale=D ** -0.5, dropout_p=dropout_p, dropout_seed=D - 3 * len(case))
    window = (100, -1) if case == "worklist_window" else (-1, -1)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*x32, lens, causal=True, window=window, **kw)
    x, do, o = [t.to(dtype) for t in x32], do32.to(dtype), o32.to(dtype)
    return call, x32, do32, dl32, lens, kw, x, do, o, o32, lse32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256] + WIDE)
@pytest.mark.parametrize("case", list(SCHED_BWD_CASES))
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
def test_causal_bwd_schedule_kernels_match_plain(dev, dtype, D, case, dropout_p):
    """Each backward schedule kernel against its plain twin (the same entry
    point on CPU copies, which walk the same block partition), MHA and GQA
    4, a dead tail, a dlse cotangent: fp32 1e-4 x (1 + max |grad|), fp16 /
    bf16 (the tensor-core kernels) the FA gradient contract against the fp32
    plain; the launches each call adds, none of the dq / dk/dv pair's
    counts; two runs equal bit for bit."""
    call, x32, do32, dl32, lens, kw, x, do, o, o32, lse32 = _sched_bwd_run(case, dev, dtype, D,
                                                                             dropout_p)
    cpu = lambda ts: [t.cpu() for t in ts]
    refs = call(flash_bwd, *cpu(x32), do32.cpu(), o32.cpu(), lse32.cpu(), lens.cpu(), dl32.cpu(),
                **kw)
    plains = call(flash_bwd, *cpu(x), do.cpu(), o.cpu(), lse32.cpu(), lens.cpu(), dl32.cpu(), **kw)
    before, pair0 = dict(flash_bwd.SCHEDULE_LAUNCHES), dict(flash_bwd.LAUNCHES)
    grads = call(flash_bwd, *x, do, o, lse32, lens, dl32, **kw)
    again = call(flash_bwd, *x, do, o, lse32, lens, dl32, **kw)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in flash_bwd.SCHEDULE_LAUNCHES.items() if c != before[n]}
    assert delta == {n: 2 * c for n, c in SCHED_BWD_CASES[case][2].items()}, delta
    assert flash_bwd.LAUNCHES == pair0
    for g, a, pl in zip(grads, again, plains):
        assert g.shape == pl.shape and g.dtype == dtype and torch.isfinite(g).all()
        assert torch.equal(a, g)
    _check_grads(cpu(grads), refs, plains, dtype)


def test_causal_bwd_schedule_kernels_ignore_nan_padding(dev):
    """Rows and columns past the lengths may hold NaN: the tri-square and
    the work list zero-fill them on load, so the gradients equal those of
    zero padding bit for bit, and the padded rows get exactly zero."""
    x32, do32, dl32, lens = _sched_bwd_inputs(dev, 128, 8, 5)
    x = [t.to(torch.bfloat16) for t in x32] + [do32.to(torch.bfloat16)]
    kw = dict(softmax_scale=128 ** -0.5)
    o, lse = flash_fwd.flash_attn_forward(*x[:3], lens, causal=True, **kw)
    nan = [t.clone() for t in x]
    for t in nan:
        t[1, :, 211:] = float("nan")
    o_n, lse_n = flash_fwd.flash_attn_forward(*nan[:3], lens, causal=True, **kw)
    for run in (lambda a, o, lse: flash_bwd.flash_attn_backward_tri_square(*a, o, lse, lens, **kw),
                lambda a, o, lse: flash_bwd.flash_attn_backward_fused_wl(*a, o, lse, lens, sub=64,
                                                                         block_kv=128, **kw)):
        base, got = run(x, o, lse), run(nan, o_n, lse_n)
        torch.cuda.synchronize()
        for g, ref in zip(got, base):
            assert torch.isfinite(g).all()
            assert torch.equal(g[0], ref[0]) and torch.equal(g[1, :, :211], ref[1, :, :211])
            assert not g[1, :, 211:].any()



@pytest.mark.parametrize("D", [128, 512])
@pytest.mark.parametrize("tile", ["q", "kv"])
def test_causal_bwd_kernels_refuse_a_partition_of_other_tiles(dev, monkeypatch, tile, D):
    """The 16-bit tri-square and work list take the tile rows the host
    partition was built for and raise when they are not the kernels' own
    (FusedKv's BQ / BKV), rather than skip or repeat tiles. Each runs once
    with the host's tiles first, which also caches its partition."""
    x32, do32, dl32, lens = _sched_bwd_inputs(dev, D, 8, 5)
    x = [t.to(torch.bfloat16) for t in x32] + [do32.to(torch.bfloat16)]
    kw = dict(softmax_scale=D ** -0.5)
    o, lse = flash_fwd.flash_attn_forward(*x[:3], lens, causal=True, **kw)
    runs = (lambda: flash_bwd.flash_attn_backward_tri_square(*x, o, lse, lens, **kw),
            lambda: flash_bwd.flash_attn_backward_fused_wl(*x, o, lse, lens, sub=64,
                                                           block_kv=128, **kw))
    for run in runs:
        run()
    torch.cuda.synchronize()
    real = getattr(flash_bwd, f"fused_{tile}_tile")
    monkeypatch.setattr(flash_bwd, f"fused_{tile}_tile", lambda head_dim: 2 * real(head_dim))
    for run in runs:
        with pytest.raises(RuntimeError, match="launch"):
            run()

@pytest.mark.parametrize("S,Hkv,route", [(250, 4, "tri_square"), (500, 1, "tri_square"),
                                         (4200, 4, "worklist")])
def test_flash_attn_func_routes_causal_backward(dev, prior_routes, S, Hkv, route):
    """The public call, bf16, B 1, D 128: MHA 4 / 4 heads at S 250 (padded
    256) and GQA 4 / 1 at S 500 (padded 512) take the tri-square backward,
    MHA at S 4200 (padded 5120, past the TPU's single strip) the work list; each launches its kernel
    once and none of the dq / dk/dv pair, and the gradients meet the FA rule
    against the fp32 plain twins."""
    D = 128
    assert flash_bwd.backward_route(S, S, D, 2, causal=True, group=4 // Hkv,
                                    static_skip=True) == route
    g = torch.Generator(device=dev).manual_seed(S)
    x32 = [torch.randn(1, S, h, D, generator=g, device=dev) * 0.5 for h in (4, Hkv, Hkv)]
    do32 = torch.randn(1, S, 4, D, generator=g, device=dev)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in x32]
    before, pair0 = dict(flash_bwd.SCHEDULE_LAUNCHES), dict(flash_bwd.LAUNCHES)
    out, lse = flash_attn_func(*leaves, causal=True, return_lse=True)
    out.backward(do32.to(torch.bfloat16))
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in flash_bwd.SCHEDULE_LAUNCHES.items() if c != before[n]}
    assert delta == {route: 1} and flash_bwd.LAUNCHES == pair0, delta
    t = lambda x: x.transpose(1, 2)
    lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
    refs = flash_bwd.flash_attn_backward_plain(*(t(x) for x in x32), t(do32), o32, lse32, lens,
                                               **kw)
    q, k, v = (t(x.detach()) for x in leaves)
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, t(do32.to(torch.bfloat16)),
                                                 t(out.detach()), lse.detach(), lens, **kw)
    _check_grads([t(x.grad) for x in leaves], refs, plains, torch.bfloat16)

# ----------------------------- speculative decoding and GPT-2 -----------------------------
# `flash_attn_with_kv_cache` is one B1 launch with the rows at a global
# offset (lens (kv_len, kv_len), q_off kv_len - S_step) over the cache's
# first kv_len rows, BHSD.

KV_CACHE_CASES = {   # name: (S_step, kv_len, Hkv, window_left, softcap)
    "decode": (1, 77, 2, -1, 0.0),
    "decode gqa 4": (1, 1000, 1, -1, 0.0),
    "verify": (5, 130, 2, -1, 0.0),
    "verify gqa 4 window": (5, 2049, 1, 100, 0.0),
    "wide softcap": (8, 300, 2, -1, 4.0),
    "wide window softcap": (8, 8, 4, 3, 4.0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128] + WIDE + WIDER)
@pytest.mark.parametrize("case", list(KV_CACHE_CASES))
def test_flash_attn_with_kv_cache_kernel_matches_plain(dev, dtype, D, case):
    from fa2_triton_tpu_torch.ops.attention import flash_attn_with_kv_cache

    S, kv_len, Hkv, window, softcap = KV_CACHE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(D + S + kv_len)
    B, Hq, S_max = 2, 4, 2176
    q32 = torch.randn(B, S, Hq, D, generator=g, device=dev) * 0.5
    k32, v32 = (torch.randn(B, Hkv, S_max, D, generator=g, device=dev) * 0.5 for _ in range(2))
    k32[:, :, kv_len:] = float("nan")        # rows past kv_len are never read
    v32[:, :, kv_len:] = float("nan")
    lens = torch.full((B, 2), kv_len, dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5, softcap=softcap,
              window=(window, 0) if window >= 0 else (-1, -1))

    def plain(q, k, v):
        o, _ = flash_fwd.flash_attn_forward_plain(q.transpose(1, 2), k[:, :, :kv_len],
                                                  v[:, :, :kv_len], lens, kv_len - S, **kw)
        return o.transpose(1, 2)

    ref = plain(q32, k32, v32)
    q, k, v = (x.to(dtype) for x in (q32, k32, v32))
    n0 = flash_fwd.LAUNCHES
    out = flash_attn_with_kv_cache(q, k, v, kv_len, window_left=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_fwd.LAUNCHES == n0 + 1
    assert out.shape == (B, S, Hq, D) and out.dtype == dtype and torch.isfinite(out).all()
    _check(out, ref, plain(q, k, v), dtype)


def _tiny_gpt2(dev, dtype, seed=0):
    from fa2_triton_tpu_torch.models import GPT2Config, gpt2

    cfg = GPT2Config(vocab_size=512, dim=256, n_layers=2, n_heads=4, hidden_dim=512,
                     max_seq_len=520, dtype=dtype)
    return gpt2.init_params(torch.Generator(device=dev).manual_seed(seed), cfg), cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt2_head_dim_64_matches_plain(dev, prior_routes, dtype, monkeypatch):
    """A 2-layer GPT-2 at head dim 64, B 2 x S 512 (the tri-square forward
    and backward, as GPT-2 small's 1024 takes): loss and every parameter
    gradient through the kernels against an fp32 run of the same weights
    with the plain attention (`flash_attn_reference`); fp32 within 1e-4 x
    (1 + max |grad|), bf16 under the FA gradient contract against the bf16
    plain run's error (as `chip_smoke.py` phase 7 holds the LLaMA layers)."""
    import dataclasses

    from fa2_triton_tpu_torch.models import gpt2
    from fa2_triton_tpu_torch.ops import flash_attn_reference

    toks = torch.randint(0, 512, (2, 513), generator=torch.Generator().manual_seed(1)).to(dev)
    model, cfg = _tiny_gpt2(dev, dtype)
    m32 = gpt2.GPT2Model(dataclasses.replace(cfg, dtype=torch.float32), device=dev)
    m32.load_state_dict(model.state_dict())

    def run(m, kernels):
        m.zero_grad(set_to_none=True)
        with monkeypatch.context() as patch:
            if not kernels:
                patch.setattr(gpt2, "flash_attn_func", lambda q, k, v, causal: flash_attn_reference(
                    q, k, v, causal=causal))
            loss = gpt2.loss_fn(m, toks)
            loss.backward()
        return loss.item(), {n: p.grad.float() for n, p in m.named_parameters()}

    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    loss, grads = run(model, True)
    torch.cuda.synchronize()
    assert flash_fwd.LAUNCHES == 2 and flash_bwd.SCHEDULE_LAUNCHES["tri_square"] == 2
    truth, truth_g = run(m32, False)
    if dtype == torch.float32:
        assert abs(loss - truth) <= 1e-4
        for n, g in grads.items():
            assert (g - truth_g[n]).abs().max() <= 1e-4 * (1 + truth_g[n].abs().max()), n
        return
    yard_loss, yard_g = run(model, False)
    assert abs(loss - truth) <= 3 * abs(yard_loss - truth) + 1e-3
    for n, g in grads.items():
        err = (g - truth_g[n]).abs().max()
        yard = (yard_g[n] - truth_g[n]).abs().max()
        assert err <= 3 * yard + 1e-5, (n, float(err), float(yard))


def test_gpt2_cached_decode_matches_the_full_forward(dev):
    from fa2_triton_tpu_torch.models import gpt2

    model, cfg = _tiny_gpt2(dev, torch.float32)
    toks = torch.randint(0, 512, (2, 300), generator=torch.Generator().manual_seed(2)).to(dev)
    caches = gpt2.init_kv_cache(cfg, 2, 320)
    full = gpt2.forward(model, toks).detach()
    flash_fwd.reset_launches()
    with torch.no_grad():
        logits, _ = gpt2.forward_with_cache(model, toks[:, :290], cfg, caches, 0)
        torch.testing.assert_close(logits, full[:, :290], rtol=0, atol=1e-4)
        for t in range(290, 300):
            logits, _ = gpt2.forward_with_cache(model, toks[:, t:t + 1], cfg, caches, t)
            torch.testing.assert_close(logits[:, 0], full[:, t], rtol=0, atol=1e-4)
    assert flash_fwd.LAUNCHES == cfg.n_layers * 11


@pytest.mark.parametrize("gamma", [1, 4])
def test_greedy_speculative_equals_greedy_reference(dev, gamma):
    """fp32 (the bf16 verify pass and width-1 step may round a near tie
    apart): the speculative stream is the target's greedy decode, with a
    1-layer draft and with the target as its own draft."""
    from fa2_triton_tpu_torch.models import LlamaConfig, init_params
    from fa2_triton_tpu_torch.runtime import SpeculativeDecoder
    from fa2_triton_tpu_torch.runtime.speculative import greedy_reference

    kw = dict(vocab_size=256, dim=256, n_heads=4, n_kv_heads=1, hidden_dim=512,
              dtype=torch.float32)
    tcfg, dcfg = LlamaConfig(n_layers=2, **kw), LlamaConfig(n_layers=1, **kw)
    target = init_params(torch.Generator(device=dev).manual_seed(0), tcfg)
    draft = init_params(torch.Generator(device=dev).manual_seed(1), dcfg)
    prompt = [(7 * j + 3) % 256 for j in range(150)]
    ref = greedy_reference(target, tcfg, prompt, 40, max_seq=256)
    for d, c in ((draft, dcfg), (target, tcfg)):
        flash_fwd.reset_launches()
        out, st = SpeculativeDecoder(target, tcfg, d, c, gamma=gamma, max_seq=256).generate(
            prompt, 40)
        assert out == ref
        assert flash_fwd.LAUNCHES == (tcfg.n_layers * (1 + st.target_calls)
                                      + c.n_layers * (1 + st.draft_calls))
        if d is target:
            assert st.acceptance_rate == 1.0


def _plain_attention(cfg):
    from fa2_triton_tpu_torch.ops import flash_attn_reference

    return lambda q, k, v: flash_attn_reference(q, k, v, causal=True, softmax_scale=cfg.scale)


def _moe_truth(layer, x, cfg):
    """An fp32 evaluation of an MoE block on the block's own routing (the
    same rms_norm output in x's dtype, so the same experts): each expert's
    SwiGLU on fp32 weights, the renormalized weights in fp32."""
    import torch.nn.functional as F

    from fa2_triton_tpu_torch.models import llama, moe

    T, D = x.shape[0] * x.shape[1], x.shape[-1]
    h = llama.rms_norm(x, layer.mlp_norm, cfg.norm_eps).reshape(T, D)
    weights, idx, _ = moe._route(h, layer.router, cfg)
    out = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        t, j = (idx == e).nonzero(as_tuple=True)
        hf = h[t].float()
        y = (F.silu(hf @ layer.we_gate[e].float()) * (hf @ layer.we_up[e].float())) \
            @ layer.we_down[e].float()
        out.index_add_(0, t, weights[t, j, None] * y)
    return x.float() + out.view(x.shape)


def test_moe_block_on_cuda_matches_its_fp32_evaluation(dev):
    """One bf16 MoE block (dim 512, 8 experts of 1024, T 1024): `moe_mlp`
    at capacity T and the dense block under the FA output rule against the
    fp32 evaluation of the same routing; at capacity T // 16 the tokens
    whose choices all missed a slot keep their residual bit for bit; the
    router and the experts get finite gradients."""
    from fa2_triton_tpu_torch.models import moe

    cfg = moe.MoEConfig(vocab_size=64, dim=512, n_layers=1, n_heads=8, n_kv_heads=2,
                        hidden_dim=1024, dtype=torch.bfloat16)
    layer = moe.init_params(torch.Generator(device=dev).manual_seed(0), cfg).layers[0]
    x = torch.randn(2, 512, 512, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    T = 1024
    with torch.no_grad():
        truth = _moe_truth(layer, x, cfg)
        sparse, _ = moe.moe_mlp(layer, x, cfg, capacity=T)
        dense, _ = moe.moe_mlp_dense(layer, x, cfg)
        _check(sparse, truth, dense, torch.bfloat16)
        small, _ = moe.moe_mlp(layer, x, cfg, capacity=T // 16)
        _, idx, _ = moe._route(moe.rms_norm(x, layer.mlp_norm, cfg.norm_eps).reshape(T, -1),
                               layer.router, cfg)
        none = ~moe._slots(idx, cfg.n_experts, T // 16)[2].view(2, T).any(dim=0)
    assert none.any()
    assert torch.equal(small.view(T, -1)[none], x.view(T, -1)[none])
    out, aux = moe.moe_mlp(layer, x, cfg)
    (out.float().square().mean() + aux).backward()
    for name in ("router", "we_gate", "we_up", "we_down"):
        g = getattr(layer, name).grad
        assert torch.isfinite(g).all() and g.abs().max() > 0, name


def test_moe_training_on_cuda_matches_plain_attention(dev, prior_routes):
    """fp32 MoE model (2 layers, 4 / 2 heads of 64, 4 experts): `moe.loss_fn`
    and every gradient, the router's included, through the forward and the
    dq + dk/dv kernels against the same with the plain attention: 1e-4 x
    (1 + max |grad|) (fp32 sums in another order; routing on equal fp32
    logits)."""
    from fa2_triton_tpu_torch.models import moe

    cfg = moe.MoEConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                        hidden_dim=512, n_experts=4, dtype=torch.float32, remat=True)
    model = moe.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(0, 256, (2, 257), generator=torch.Generator().manual_seed(1)).to(dev)

    def run(attention_fn):
        model.zero_grad(set_to_none=True)
        loss = moe.loss_fn(model, toks, attention_fn)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    loss, grads = run(None)
    torch.cuda.synchronize()
    # S 256, group 2: the tri-square backward (flash_bwd.backward_route).
    assert flash_fwd.LAUNCHES == 4 and flash_bwd.SCHEDULE_LAUNCHES["tri_square"] == 2
    truth, truth_g = run(_plain_attention(cfg))
    assert abs(loss - truth) <= 1e-4
    for n, g in grads.items():
        assert (g - truth_g[n]).abs().max() <= 1e-4 * (1 + truth_g[n].abs().max()), n


@pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn])
def test_quantized_model_on_cuda_matches_plain_attention(dev, qdtype):
    """A weight-only quantized fp32 model: the forward through the kernels
    against the plain attention within 1e-4, and the paged Engine equal to
    its own greedy forward."""
    from fa2_triton_tpu_torch.models import llama
    from fa2_triton_tpu_torch.runtime import Engine

    cfg = llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            hidden_dim=512, dtype=torch.float32)
    qm = llama.quantize_model_params(
        llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg), qdtype)
    toks = torch.randint(0, 256, (2, 200), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        flash_fwd.reset_launches()
        got = llama.forward(qm, toks)
        assert flash_fwd.LAUNCHES == cfg.n_layers
        torch.testing.assert_close(got, llama.forward(qm, toks, _plain_attention(cfg)),
                                   rtol=0, atol=1e-4)
        prompt = toks[0, :150].tolist()
        engine = Engine(qm, cfg, n_slots=2, max_seq=256, paged=True, page_size=128)
        req = engine.submit(prompt, 6)
        engine.run()
        full = llama.forward(qm, torch.tensor([prompt + req.out_tokens[:-1]], device=dev))
        top2 = full[0, len(prompt) - 1:].topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
        assert req.out_tokens == full[0, len(prompt) - 1:].argmax(-1).tolist()


def test_lora_merged_training_on_cuda_matches_plain_attention(dev, prior_routes):
    """LoRA on an fp32 model with remat: `lora_loss_fn` and the adapter
    gradients through the kernels against the plain attention within 1e-4
    x (1 + max |grad|); the frozen base gets no gradient."""
    from fa2_triton_tpu_torch.models import llama, lora

    cfg = llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            hidden_dim=512, dtype=torch.float32, remat=True)
    model = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    model.requires_grad_(False)
    adapters = lora.init_lora(torch.Generator(device=dev).manual_seed(1), model, rank=8)
    with torch.no_grad():
        for p in adapters.parameters():
            p.add_(0.01)
    toks = torch.randint(0, 256, (2, 257), generator=torch.Generator().manual_seed(1)).to(dev)

    def run(attention_fn):
        adapters.zero_grad(set_to_none=True)
        loss = lora.lora_loss_fn(model, adapters, toks,
                                 lambda m, t: llama.loss_fn(m, t, attention_fn))
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in adapters.named_parameters()}

    flash_bwd.reset_launches()
    loss, grads = run(None)
    torch.cuda.synchronize()
    assert flash_bwd.SCHEDULE_LAUNCHES["tri_square"] == cfg.n_layers
    truth, truth_g = run(_plain_attention(cfg))
    assert abs(loss - truth) <= 1e-4
    for n, g in grads.items():
        assert (g - truth_g[n]).abs().max() <= 1e-4 * (1 + truth_g[n].abs().max()), n
    assert all(p.grad is None for p in model.parameters())


# ---------------- runtime and training extras (utils/) ----------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"), float("-inf")])
def test_tree_allfinite_on_the_card_equals_the_cpu(dev, dtype, bad):
    from fa2_triton_tpu_torch.utils.resilience import tree_allfinite

    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(n, generator=gen).to(dtype) for n in (1, 7, 4099, 1 << 20)]
    leaves[1][3] = torch.finfo(dtype).max
    if bad is not None:
        leaves[3][12345] = bad
    tree = {"a": leaves[:2], "b": (leaves[2], {"c": leaves[3]}), "n": torch.arange(3)}
    on_card = {"a": [x.to(dev) for x in leaves[:2]], "b": (leaves[2].to(dev), {"c": leaves[3].to(dev)}),
               "n": torch.arange(3, device=dev)}
    got = tree_allfinite(on_card)
    assert got.device.type == "cuda" and bool(got) == bool(tree_allfinite(tree)) == (bad is None)


def test_guarded_step_skips_a_nan_step_on_the_card(dev):
    from fa2_triton_tpu_torch.examples import train
    from fa2_triton_tpu_torch.models import init_params, llama
    from fa2_triton_tpu_torch.utils.resilience import make_guarded_step

    cfg = llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                            hidden_dim=512, max_seq_len=256, dtype=torch.bfloat16)
    model = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    state = {"model": model, "opt": train.make_optimizer(model, 1e-3), "step": 0}
    good = make_guarded_step(*train.step_fns(cfg, lambda s: 1e-3, 1.0))
    bad = make_guarded_step(*train.step_fns(
        cfg, lambda s: 1e-3, 1.0, loss=lambda m, t: llama.loss_fn(m, t) * float("nan")))
    tokens = torch.randint(0, 256, (2, 129), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    state, _, ok = good(state, tokens)
    assert ok
    before = [t.clone() for p in model.parameters() for t in [p, *state["opt"].state[p].values()]]
    state, _, ok = bad(state, tokens)
    after = [t for p in model.parameters() for t in [p, *state["opt"].state[p].values()]]
    assert not ok and state["step"] == 1
    assert all(torch.equal(a, b) for a, b in zip(after, before, strict=True))


def test_prefetch_to_device_defaults_to_the_card(dev):
    import numpy as np

    from fa2_triton_tpu_torch.utils.data import prefetch_to_device

    host = [np.full((2, 5), i, np.int32) for i in range(5)]
    got = list(prefetch_to_device(iter(host)))
    assert all(t.is_cuda and t.dtype == torch.int32 for t in got)
    assert all(np.array_equal(t.cpu().numpy(), h) for t, h in zip(got, host, strict=True))


def test_device_time_of_a_card_call_is_positive(dev):
    from fa2_triton_tpu_torch.utils.benchmarking import device_time

    x = torch.randn(1024, 1024, device=dev)
    t = device_time(torch.matmul, x, x)
    assert 0 < t < 1.0


# ------------- the tuning table's routes (ops/tables/tuning_h100.json) -------------

def _fwd_launched(route):
    """flash_fwd's launch deltas of one forward that took `route`."""
    if route == "split":
        return {"causal_diag": 1, "rect_merge": 1}, 0
    return ({"causal_strip": 1} if route == "strip" else {}), 1 - (route == "strip")


def _bwd_launched(route, S, D, group):
    """flash_bwd's schedule and pair deltas of one backward at S x S that
    took `route` (the split: one diag launch, one region backward per
    rectangle of its default leaf)."""
    if route in ("strip", "generic"):
        return {}, {"flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}
    if route == "split":
        Sq_p, _, Dp = flash_fwd.jax_padded_shape(S, S, D, 2)
        leaf = flash_bwd.bwd_split_leaf_t(Dp, group)
        return ({"causal_diag": 1, "rect": len(flash_fwd.causal_split_rects(-(-Sq_p // leaf)))},
                {n: 0 for n in flash_bwd.LAUNCHES})
    return {route: 1}, {n: 0 for n in flash_bwd.LAUNCHES}


def _public_run(dev, S, Hq, Hkv, D, x32, do32, prior, monkeypatch):
    """flash_attn_func fwd + bwd in bf16 with the table (or without it:
    `prior`), returning (out, lse, grads, flash_fwd deltas, flash_bwd
    deltas)."""
    with monkeypatch.context() as m:
        if prior:
            m.setenv("FA2_DISABLE_TUNING_TABLE", "1")
        leaves = [t.to(torch.bfloat16).requires_grad_() for t in x32]
        f0, fl0 = dict(flash_fwd.SCHEDULE_LAUNCHES), flash_fwd.LAUNCHES
        b0, bl0 = dict(flash_bwd.SCHEDULE_LAUNCHES), dict(flash_bwd.LAUNCHES)
        out, lse = flash_attn_func(*leaves, causal=True, return_lse=True)
        out.backward(do32.to(torch.bfloat16))
        torch.cuda.synchronize()
    fwd = ({n: c - f0[n] for n, c in flash_fwd.SCHEDULE_LAUNCHES.items() if c != f0[n]},
           flash_fwd.LAUNCHES - fl0)
    bwd = ({n: c - b0[n] for n, c in flash_bwd.SCHEDULE_LAUNCHES.items() if c != b0[n]},
           {n: c - bl0[n] for n, c in flash_bwd.LAUNCHES.items()})
    return out, lse, [x.grad for x in leaves], fwd, bwd


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_table_routes_and_their_priors_match_plain(dev, D, group, monkeypatch):
    """For every bucket of the shipped table at this head dim and group:
    `flash_attn_func` (bf16, B 1, 4 / 4 // group heads, length bucket - 1)
    with the table takes its `fwd_route` / `bwd_route` entries and without
    it (FA2_DISABLE_TUNING_TABLE=1) the prior's routes, the launch counters
    show each route, and both runs meet the FA rules against the fp32 plain
    twins."""
    import json

    from fa2_triton_tpu_torch.ops import autotune

    chip = autotune.detect_chip(dev)
    monkeypatch.delenv("FA2_DISABLE_TUNING_TABLE", raising=False)
    autotune._load_table.cache_clear()
    table = json.loads(autotune.table_paths(chip)[0].read_text())
    Hq, Hkv = 4, 4 // group
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    for bucket in sorted({int(k.split(":")[3]) for k in table}):
        S = bucket - 1
        want = {"fwd": table.get(f"fwd_route:1:{D}:{bucket}", [None])[0],
                "bwd": table.get(f"bwd_route+g{group}:1:{D}:{bucket}", [None])[0]}
        routes = {"table": (flash_fwd.forward_route(S, S, D, 2, static_skip=True, chip=chip,
                                                    causal=True),
                            flash_bwd.backward_route(S, S, D, 2, group=group, static_skip=True,
                                                     chip=chip, causal=True)),
                  "prior": (flash_fwd.forward_route(S, S, D, 2, static_skip=True, causal=True),
                            flash_bwd.backward_route(S, S, D, 2, group=group, static_skip=True,
                                                     causal=True))}
        assert routes["table"] == (want["fwd"] or routes["prior"][0],
                                   want["bwd"] or routes["prior"][1]), (bucket, routes)
        g = torch.Generator(device=dev).manual_seed(bucket + D + group)
        x32 = [torch.randn(1, S, h, D, generator=g, device=dev) * 0.5 for h in (Hq, Hkv, Hkv)]
        do32 = torch.randn(1, S, Hq, D, generator=g, device=dev)
        lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
        o32, lse32 = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
        refs = flash_bwd.flash_attn_backward_plain(*(t(x) for x in x32), t(do32), o32, lse32,
                                                   lens, **kw)
        xb = [t(x.to(torch.bfloat16)) for x in x32]
        o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(*xb, lens, **kw)
        plains = flash_bwd.flash_attn_backward_plain(*xb, t(do32.to(torch.bfloat16)), o_pl,
                                                     lse_pl, lens, **kw)
        for which in ("table", "prior"):
            if which == "prior" and routes["prior"] == routes["table"]:
                continue
            out, lse, grads, fwd, bwd = _public_run(dev, S, Hq, Hkv, D, x32, do32,
                                                    which == "prior", monkeypatch)
            f_route, b_route = routes[which]
            assert fwd == _fwd_launched(f_route), (bucket, which, f_route, fwd)
            assert bwd == _bwd_launched(b_route, S, D, group), (bucket, which, b_route, bwd)
            _check(t(out), o32, o_pl, torch.bfloat16)
            assert (lse - lse_pl).abs().max().item() <= 1e-4
            _check_grads([t(x) for x in grads], refs, plains, torch.bfloat16)
        del o32, refs, plains
        torch.cuda.empty_cache()


@pytest.mark.parametrize("compute", [None, torch.bfloat16])
def test_fp16_flash_attn_func_picks_its_kernels(dev, compute):
    """fp16 through flash_attn_func computes in fp32 by default (the FMA
    kernels: no tensor-core instantiation in the profile) and with
    fp16_compute_dtype=bfloat16 on the bf16 tensor-core kernels; the output
    and gradients come back in fp16 and meet the FA rules against the fp32
    plain twins."""
    g = torch.Generator(device=dev).manual_seed(5)
    S, D = 300, 128
    x32 = [torch.randn(2, S, h, D, generator=g, device=dev) * 0.5 for h in (8, 2, 2)]
    do32 = torch.randn(2, S, 8, D, generator=g, device=dev)
    leaves = [x.half().requires_grad_() for x in x32]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out, lse = flash_attn_func(*leaves, causal=True, return_lse=True,
                                   fp16_compute_dtype=compute)
        out.backward(do32.half())
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    mma = ("flash_fwd_mma_kernel" in names, "dq_mma_kernel" in names)
    assert mma == ((False, False) if compute is None else (True, True)), names
    if compute is not None:
        assert "bfloat16" in names, names
    assert out.dtype == torch.float16 and all(x.grad.dtype == torch.float16 for x in leaves)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    lens = torch.tensor([[S, S]] * 2, dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
    refs = flash_bwd.flash_attn_backward_plain(*(t(x) for x in x32), t(do32), o32, lse32, lens,
                                               **kw)
    xl = [t(x.half().to(compute or torch.float16)) for x in x32]   # as the call computes
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(*xl, lens, **kw)
    plains = flash_bwd.flash_attn_backward_plain(*xl, t(do32.to(xl[0].dtype)), o_pl, lse_pl,
                                                 lens, **kw)
    _check(t(out), o32, o_pl, torch.float16)
    _check_grads([t(x.grad) for x in leaves], refs, plains, torch.float16)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_fp16_instantiations_at_the_ops_level(dev, D):
    """The 16-bit fp16 kernels stay reachable below the public API: the
    forward, the dq + dk/dv pair, the tri-square backward and the packed
    forward / backward on fp16 tensors, each against its fp32 plain twin
    under the FA rules."""
    from fa2_triton_tpu_torch.ops import varlen

    g = torch.Generator(device=dev).manual_seed(D)
    S = 256
    x32 = [(torch.randn(1, S, h, D, generator=g, device=dev) * 0.5).transpose(1, 2)
           for h in (4, 4, 4)]
    do32 = torch.randn(1, S, 4, D, generator=g, device=dev).transpose(1, 2)
    lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    x16, do16 = [x.half() for x in x32], do32.half()
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*x32, lens, **kw)
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(*x16, lens, **kw)
    o, lse = flash_fwd.flash_attn_forward(*x16, lens, route="generic", static_skip=True, **kw)
    assert o.dtype == torch.float16
    _check(o, o32, o_pl, torch.float16)
    refs = flash_bwd.flash_attn_backward_plain(*x32, do32, o32, lse32, lens, **kw)
    plains = flash_bwd.flash_attn_backward_plain(*x16, do16, o_pl, lse_pl, lens, **kw)
    for route in ("generic", "tri_square"):
        grads = flash_bwd.flash_attn_backward(*x16, do16, o, lse, lens, route=route,
                                              static_skip=True, **kw)
        assert all(x.dtype == torch.float16 for x in grads)
        _check_grads(grads, refs, plains, torch.float16)
    bq, bkv = VARLEN_BLOCKS[D]
    _varlen_check(dev, torch.float16, [0, 256], (200, 100), (200, 100), 512, 4, 2, D, seed=D,
                  causal=True, softmax_scale=D ** -0.5, block_q=bq, block_kv=bkv)
    assert varlen.LAUNCHES["varlen_fwd"] > 0


def test_baselines_run_on_the_card(dev):
    """The yardsticks of other_implementations on CUDA tensors, bf16,
    causal, GQA 2: each against the fp32 dense baseline within the FA
    rule's yardstick (the bf16 dense baseline's own error)."""
    from fa2_triton_tpu_torch.other_implementations import (
        dense_attention, flex_attention, sdpa_flash_attention)

    g = torch.Generator(device=dev).manual_seed(1)
    x32 = [torch.randn(2, 512, h, 64, generator=g, device=dev) * 0.5 for h in (8, 4, 4)]
    ref = dense_attention(*x32, causal=True)
    xb = [x.bfloat16() for x in x32]
    yard = (dense_attention(*xb, causal=True).float() - ref).abs().max().item()
    for fn in (sdpa_flash_attention, flex_attention):
        out = fn(*xb, causal=True)
        assert out.shape == ref.shape and out.dtype == torch.bfloat16
        assert (out.float() - ref).abs().max().item() <= 2 * yard + 5e-5, fn.__name__


# Ring attention's diagonal chunk pairs (parallel/ring.py): a causal call on
# one chunk at global offsets q_off = kv_off = 2 x C with the real lengths of
# a 4-chunk sequence, q pre-scaled by softmax_scale x log2(e), each route
# forced where its prior gate passes at that shape (the gates are pure
# Python, so the cases are listed at import: none is skipped).
RING_CHUNKS = (1024, 2048, 4096)


def _ring_fwd_cases():
    out = []
    for dtype, nbytes in ((torch.float32, 4), (torch.bfloat16, 2)):
        for route in ("tri_square", "strip", "split", "generic"):
            C = next((c for c in RING_CHUNKS if flash_fwd.forward_gates(
                c, c, 128, nbytes, causal=True, static_skip=True, seqlen_q_real=4 * c,
                seqlen_k_real=4 * c)[route]), None)
            if C is not None:
                out.append((dtype, route, C))
    return out


def _ring_bwd_cases():
    out = []
    for dtype, nbytes in ((torch.float32, 4), (torch.bfloat16, 2)):
        for group in (1, 4):
            for route in ("tri_square", "split", "strip", "worklist", "generic"):
                C = next((c for c in RING_CHUNKS + (8192,) if flash_bwd.backward_gates(
                    c, c, 128, nbytes, causal=True, group=group, static_skip=True,
                    seqlen_q_real=4 * c, seqlen_k_real=4 * c)[route]), None)
                if C is not None:
                    out.append((dtype, route, C, group))
    return out


def _ring_pair_inputs(dev, C, Hq, Hkv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x32 = [(torch.randn(1, C, h, 128, generator=g, device=dev) * 0.5).transpose(1, 2)
           for h in (Hq, Hkv, Hkv)]
    do32 = torch.randn(1, C, Hq, 128, generator=g, device=dev).transpose(1, 2)
    dl32 = torch.randn(1, Hq, C, generator=g, device=dev) * 0.1
    lens = torch.tensor([[4 * C, 4 * C]], dtype=torch.int32, device=dev)
    return x32, do32, dl32, lens


@pytest.mark.parametrize("dtype,route,C", _ring_fwd_cases())
def test_ring_diag_pair_forward_routes_match_plain(dev, dtype, route, C):
    """The forward of a ring's diagonal pair on each route, q_prescaled,
    against the plain twin at the same offsets and real lengths (fp32 with
    dropout, p 0.1: the single-device counter stream at global positions;
    bf16 without), and the route's launch."""
    x32, _, _, lens = _ring_pair_inputs(dev, C, 4, 1, C + len(route))
    scale = 128 ** -0.5
    q32 = x32[0] * (scale * 1.4426950408889634)
    drop = dict(dropout_p=0.1, dropout_seed=77) if dtype == torch.float32 else {}
    kw = dict(causal=True, softmax_scale=scale, seqlen_q_real=4 * C, seqlen_k_real=4 * C,
              q_prescaled=True, **drop)
    x = [q32.to(dtype)] + [t.to(dtype) for t in x32[1:]]
    flash_fwd.reset_launches()
    o, lse = flash_fwd.flash_attn_forward(*x, lens, 2 * C, 2 * C, static_skip=True, route=route,
                                          **kw)
    torch.cuda.synchronize()
    launched = {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES}
    want = ({"causal_diag": 1, "rect_merge": 1} if route == "split" else
            {"causal_strip": 1} if route == "strip" else {"flash_fwd": 1})
    assert {n: c for n, c in launched.items() if c} == want
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, *x32[1:], lens, 2 * C, 2 * C, **kw)
    o_pl, _ = flash_fwd.flash_attn_forward_plain(*x, lens, 2 * C, 2 * C, **kw)
    _check(o, o32, o_pl, dtype)
    if dtype == torch.float32:
        assert (lse - lse32).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype,route,C,group", _ring_bwd_cases())
def test_ring_diag_pair_backward_routes_match_plain(dev, dtype, route, C, group):
    """The backward of a ring's diagonal pair on each route with a dlse,
    against the plain twin at the same offsets and real lengths (fp32 with
    dropout, p 0.1; bf16 without), and the route's launch."""
    Hq = 4
    x32, do32, dl32, lens = _ring_pair_inputs(dev, C, Hq, Hq // group, C + group)
    drop = dict(dropout_p=0.1, dropout_seed=91) if dtype == torch.float32 else {}
    kw = dict(causal=True, softmax_scale=128 ** -0.5, seqlen_q_real=4 * C, seqlen_k_real=4 * C,
              **drop)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*x32, lens, 2 * C, 2 * C, **kw)
    x, do, o = [t.to(dtype) for t in x32], do32.to(dtype), o32.to(dtype)
    flash_bwd.reset_launches()
    grads = flash_bwd.flash_attn_backward(*x, do, o, lse32, lens, 2 * C, 2 * C, dlse=dl32,
                                          static_skip=True, route=route, **kw)
    torch.cuda.synchronize()
    sched = {n: c for n, c in flash_bwd.SCHEDULE_LAUNCHES.items() if c}
    pair = {n: c for n, c in flash_bwd.LAUNCHES.items() if c}
    if route in ("generic", "strip"):
        assert not sched and pair == {"flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
    elif route == "split":
        assert set(sched) == {"causal_diag", "rect"} and not pair
    else:
        assert sched == {route: 1} and not pair
    refs = flash_bwd.flash_attn_backward_plain(*x32, do32, o32, lse32, lens, 2 * C, 2 * C,
                                               dlse=dl32, **kw)
    plains = flash_bwd.flash_attn_backward_plain(*x, do, o, lse32, lens, 2 * C, 2 * C, dlse=dl32,
                                                 **kw)
    _check_grads(grads, refs, plains, dtype)


def test_parallel_attention_on_cuda_ranks(dev):
    """Ring (causal zigzag, with dropout and lse), Ulysses and TP attention
    on 4 ranks that share this card over gloo (CUDA tensors staged through
    the host), bf16, against flash_attn_func on one card under the FA
    rules (fp32 flash_attn_func the truth, the bf16 plain reference the
    yardstick)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_parallel_ranks as tpr
    from fa2_triton_tpu_torch.ops.reference import flash_attn_reference
    from fa2_triton_tpu_torch.parallel import spawn_ranks

    shape = (1, 2048, 8, 4, 128)
    cases = [dict(kind="ring", mesh={"seq": 4}, shape=shape, seed=5, dtype="bfloat16", lse=True,
                  kw=dict(causal=True, dropout_p=0.1, dropout_seed=9)),
             dict(kind="ulysses", mesh={"seq": 4}, shape=shape, seed=6, dtype="bfloat16",
                  kw=dict(causal=True)),
             dict(kind="tp", mesh={"data": 2, "model": 2}, shape=(2,) + shape[1:], seed=7,
                  dtype="bfloat16", kw=dict(causal=True))]
    got = spawn_ranks(tpr.attention_cases_rank, 4, (cases, "cuda"), timeout_s=600)[0]
    for case, res in zip(cases, got):
        q, k, v, do, dlse = tpr.attention_inputs(*case["shape"], case["seed"], dev)
        kw = case["kw"]
        p = kw.get("dropout_p", 0.0)
        B = case["shape"][0]
        mask = (flash_fwd.dropout_mask(B, 8, 2048, 2048, 0, 0, p, kw["dropout_seed"], 2048, 2048,
                                       dev) if p else None)
        runs = []
        for dt, upcast in ((torch.float32, True), (torch.bfloat16, False)):
            x = [t.detach().clone().to(dt).requires_grad_() for t in (q, k, v)]
            o, lse = flash_attn_reference(*x, causal=True, dropout_p=p, dropout_mask=mask,
                                          upcast=upcast, return_lse=True)
            loss = (o.float() * do).sum() + ((lse.float() * dlse).sum() if case.get("lse") else 0)
            loss.backward()
            runs.append((o, [t.grad for t in x]))
        (o32, g32), (o16, g16) = runs
        _check(torch.from_numpy(res["out"]).to(dev), o32, o16, torch.bfloat16)
        _check_grads([torch.from_numpy(res[n]).to(dev) for n in ("dq", "dk", "dv")], g32, g16,
                     torch.bfloat16)


# ------------------------------ head dims 384 and 512 ------------------------------
# The forward (8 warps, two per 16 q rows, each on half of O's columns), the
# dq kernel (the same pairs, K / V tiles of 32 / 16 rows), the dk/dv kernel
# (32 kv rows x 32-row q tiles, 4 warps along D), the FMA kernels (32 x 16
# tiles) and decode (2 warps, q in shared memory).

WIDE_EXTRA = {   # name: (flash_fwd / flash_bwd keywords, whether a bias rides along)
    "bias": (dict(), True),
    "dropout": (dict(dropout_p=0.17, dropout_seed=-5), False),
    "dropout bias window": (dict(dropout_p=0.1, dropout_seed=9, window=(40, 0)), True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", WIDE + WIDER)
@pytest.mark.parametrize("case", list(WIDE_EXTRA))
def test_wide_head_dims_bias_and_dropout_match_plain(dev, dtype, D, case):
    """The EXTRA and DROP instantiations past D 256: forward, dq and dk/dv
    with a bias that needs no gradient (dbias stopped at D 256 then; past
    512 it is not built yet) or dropout,
    against the plain twins (FA rules), one launch each and no dbias
    (softcap: FWD_CASES / BWD_CASES at every D)."""
    extra, with_bias = WIDE_EXTRA[case]
    (q32, k32, v32, do32), lens, q_off, kw = _bwd_inputs(dev, dict(), D, D + len(case))
    kw.update(extra)
    b32 = None
    if with_bias:
        b32 = torch.randn(1, 8, q32.shape[2], k32.shape[2],
                          generator=torch.Generator(device=dev).manual_seed(D), device=dev)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, q_off, 0, b32, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, q_off, 0, b32,
                                               **kw)
    q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
    bias = None if b32 is None else b32.to(dtype)
    fwd0, bwd0 = flash_fwd.LAUNCHES, dict(flash_bwd.LAUNCHES)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, q_off, 0, bias, **kw)
    grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, q_off, 0, bias, **kw)
    launched = (flash_fwd.LAUNCHES - fwd0,
                *(flash_bwd.LAUNCHES[n] - bwd0[n] for n in sorted(bwd0)))
    assert launched == (1, 0, 1, 1), launched     # fwd, dbias, dq, dk/dv
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(q, k, v, lens, q_off, 0, bias, **kw)
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, q_off, 0, bias, **kw)
    torch.cuda.synchronize()
    _check(o, o32, o_pl, dtype)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_pl))
    fin = torch.isfinite(lse_pl)
    assert (lse[fin] - lse_pl[fin]).abs().max().item() <= 1e-4
    _check_grads(grads, refs, plains, dtype)


@pytest.mark.parametrize("D", [300, 448, 600, 1000])
def test_wide_head_dims_off_the_kernel_widths_are_padded(dev, D):
    """flash_attn_func at a head dim past 256 but off the kernels' widths
    (padded to 384 / 512 / 640 / 1024, JAX's round-up to 128) matches the
    same call on the CPU, fp32, forward and gradients, with dropout."""
    rng = torch.Generator().manual_seed(D)
    x = [torch.randn(2, 130, h, D, generator=rng) * 0.5 for h in (4, 2, 2)]
    results = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_() for t in x]
        out = flash_attn_func(*leaves, causal=True, dropout_p=0.1, dropout_seed=D)
        out.float().square().sum().backward()
        assert out.shape[-1] == D
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("S,Hkv,route", [(256, 4, "tri_square"), (2047, 8, "worklist")])
def test_wide_head_dims_take_jax_fused_schedule(dev, prior_routes, D, S, Hkv, route):
    """The public call, bf16, B 2 x 8 query heads: at S 256 with GQA 2 JAX's
    gates send the backward to the tri-square, at 2047 with MHA to the work
    list, and past D 256 the card now takes that fused schedule too (one
    launch of it, none of the dq + dk/dv pair; the forward's route is the
    generic kernel or its strip); the FA rules against the fp32 plain twins."""
    g = torch.Generator(device=dev).manual_seed(D + S)
    x32 = [torch.randn(2, S, h, D, generator=g, device=dev) * 0.5 for h in (8, Hkv, Hkv)]
    do32 = torch.randn(2, S, 8, D, generator=g, device=dev)
    assert flash_bwd.backward_route(S, S, D, 2, causal=True, group=8 // Hkv,
                                    static_skip=True) == route
    leaves = [x.to(torch.bfloat16).requires_grad_() for x in x32]
    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    out = flash_attn_func(*leaves, causal=True)
    out.backward(do32.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert flash_fwd.LAUNCHES + sum(flash_fwd.SCHEDULE_LAUNCHES.values()) == 1
    assert not any(flash_bwd.LAUNCHES.values())
    assert {n: c for n, c in flash_bwd.SCHEDULE_LAUNCHES.items() if c} == {route: 1}
    t = lambda x: x.transpose(1, 2)
    lens = torch.tensor([[S, S]] * 2, dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
    refs = flash_bwd.flash_attn_backward_plain(*(t(x) for x in x32), t(do32), o32, lse32, lens,
                                               **kw)
    xl = [t(x.detach()) for x in leaves]
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(*xl, lens, **kw)
    plains = flash_bwd.flash_attn_backward_plain(*xl, t(do32.to(torch.bfloat16)), o_pl, lse_pl,
                                                 lens, **kw)
    _check(t(out.detach()), o32, o_pl, torch.bfloat16)
    _check_grads([t(x.grad) for x in leaves], refs, plains, torch.bfloat16)


@pytest.mark.parametrize("D", WIDE)
def test_wide_fused_schedules_and_dbias_are_bitwise_repeatable(dev, D):
    """5 runs each of the tri-square, the diag leaves, the work list (two
    strips) and dbias past D 256, bf16 with dropout: identical gradients (no
    atomics; fixed partitions and summation orders)."""
    drop = dict(softmax_scale=D ** -0.5, dropout_p=0.1, dropout_seed=D)
    x32, do32, dl32, lens = _sched_bwd_inputs(dev, D, 8, D, S=1000)   # MHA: the strips' dq
    x = [t.to(torch.bfloat16) for t in x32] + [do32.to(torch.bfloat16)]
    o, lse = flash_fwd.flash_attn_forward(*x[:3], lens, causal=True, **drop)
    bias = torch.randn(1, 8, 1000, 1000, device=dev).to(torch.bfloat16)
    ob, lseb = flash_fwd.flash_attn_forward(*x[:3], lens, 0, 0, bias, causal=True, **drop)
    calls = {"tri_square": lambda: _tri(flash_bwd, *x, o, lse, lens, dl32, **drop),
             "diag": lambda: _diag(flash_bwd, *x, o, lse, lens, dl32, T=256, **drop),
             "worklist": lambda: flash_bwd.flash_attn_backward_fused_wl(
                 *x, o, lse, lens, dlse=dl32, sub=256, block_kv=512, **drop),
             "dbias": lambda: flash_bwd.flash_attn_backward(
                 *x, ob, lseb, lens, 0, 0, bias, causal=True, compute_dbias=True, **drop)}
    for name, call in calls.items():
        runs = [call() for _ in range(5)]
        torch.cuda.synchronize()
        for run in runs[1:]:
            for a, b in zip(run, runs[0]):
                assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("bias_b", [1, 2])
def test_wide_dbias_with_dropout_matches_plain(dev, dtype, D, bias_b):
    """dbias past D 256 with dropout, a [1, 8, S, S] and a [2, 1, S, S] bias
    (summed over the batch, and over the q heads of a GQA 4 call): one dbias
    launch, the FA gradient contract against the fp32 plain twin (fp32
    within 1e-4 x (1 + max |grad|))."""
    (q32, k32, v32, do32), lens, _, kw = _bwd_inputs(dev, dict(), D, D + bias_b)
    kw.update(dropout_p=0.1, dropout_seed=D + bias_b)
    shape = (1, 8, 200, 200) if bias_b == 1 else (2, 1, 200, 200)
    b32 = torch.randn(*shape, generator=torch.Generator(device=dev).manual_seed(D), device=dev)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, 0, 0, b32, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, 0, 0, b32,
                                               compute_dbias=True, **kw)
    q, k, v, do, bias = (x.to(dtype) for x in (q32, k32, v32, do32, b32))
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, 0, 0, bias, **kw)
    before = flash_bwd.LAUNCHES["flash_bwd_dbias"]
    grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, 0, 0, bias,
                                          compute_dbias=True, **kw)
    assert flash_bwd.LAUNCHES["flash_bwd_dbias"] == before + 1
    plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, 0, 0, bias,
                                                 compute_dbias=True, **kw)
    torch.cuda.synchronize()
    assert grads[3].shape == shape and torch.isfinite(grads[3]).all()
    _check_grads(grads, refs, plains, dtype)


@pytest.mark.parametrize("head_dim", [16, 96, 384, 600])
@pytest.mark.parametrize("mode", [dict(), dict(paged=True, qdtype="int8")])
def test_engine_at_any_head_dim_on_cuda_matches_the_cpu(dev, head_dim, mode):
    """The serving caches are allocated at the kernels' head dim (16 -> 64,
    96 -> 128, 384), so decode runs on the card at a model head dim the
    kernel is not built for (Phi-3-mini's 96): greedy tokens equal the CPU
    Engine's, log-probs within 1e-3, the stored rows' padding zero."""
    from fa2_triton_tpu_torch.models import LlamaConfig, init_params
    from fa2_triton_tpu_torch.runtime import Engine

    cfg = LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                      hidden_dim=256, head_dim=head_dim, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = init_params(torch.Generator().manual_seed(0), cfg).to(dev)
    prompts = [[(7 * i + 3 * j) % 256 for j in range(n)] for i, n in enumerate((5, 40, 130))]
    kw = dict(mode)
    if kw.get("qdtype"):
        kw["qdtype"] = torch.int8
    outs = []
    for model in (cpu, gpu):
        decode.reset_launches()
        eng = Engine(model, cfg, n_slots=2, max_seq=512, **kw)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        outs.append(reqs)
        cache = eng.pcache.pools[0] if kw.get("paged") else eng.caches[0]
        assert cache["k"].shape[-1] == {16: 64, 96: 128, 384: 384, 600: 640}[head_dim]
        assert not cache["k"][..., head_dim:].float().any()
    assert decode.LAUNCHES > 0
    for a, b in zip(*outs):
        assert a.out_tokens == b.out_tokens
        torch.testing.assert_close(torch.tensor(b.out_logprobs), torch.tensor(a.out_logprobs),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("D", WIDER)
def test_wider_kernels_are_bitwise_repeatable_and_their_chunks_agree(dev, D):
    """Past D 512, bf16: every column chunk of a q tile computes the same
    lse bit for bit (each writes its own, `chunk_lse`), equal to the call's;
    5 runs each of the forward with dropout, the forced split (its merges
    read the previous lse from a copy while the chunks write the new one),
    the dq + dk/dv pair with a bias and dropout, and split-KV decode give
    identical outputs (no atomics; fixed orders)."""
    (q, k, v, do), lens, _, kw = _bwd_inputs(dev, dict(sq=333, sk=333, lens=(333, 256)), D, D)
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    drop = dict(dropout_p=0.1, dropout_seed=D)
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw, **drop)
    _, per_chunk = flash_fwd._flash_fwd_launch(q, k, v, lens, 0, 0, None, seqlen_q_real=None,
                                               seqlen_k_real=None, chunk_lse=True, **kw, **drop)
    assert per_chunk.shape[0] == flash_fwd.col_chunks(D) == -(-D // 256)
    for c in range(per_chunk.shape[0]):
        assert torch.equal(per_chunk[c].view(torch.int32), lse.view(torch.int32)), c

    def fwd():
        return flash_fwd.flash_attn_forward(q, k, v, lens, **kw, **drop)

    bias = torch.randn(1, 8, 333, 333, device=dev, dtype=torch.bfloat16)

    def bwd():
        o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, 0, 0, bias, **kw, **drop)
        return flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, 0, 0, bias, **kw, **drop)

    xs = [(torch.randn(1, 512, h, D, device=dev) * 0.5).to(torch.bfloat16).transpose(1, 2)
          for h in (4, 2, 2)]
    lens_s = torch.tensor([[512, 512]], dtype=torch.int32, device=dev)

    def split():
        return flash_fwd.flash_attn_forward(*xs, lens_s, causal=True, softmax_scale=D ** -0.5,
                                            static_skip=True, tri_square=False, causal_split=True,
                                            split_leaf=128)

    qd = (torch.randn(3, 8, D, device=dev) * 0.5).to(torch.bfloat16)
    kc, vc = ((torch.randn(3, 2, 1500, D, device=dev) * 0.5).to(torch.bfloat16) for _ in range(2))
    kv_lens = torch.tensor([1, 700, 1500], dtype=torch.int32, device=dev)

    def dec():
        return (decode.decode_attention(qd, kc, vc, kv_lens),)

    for run in (fwd, split, bwd, dec):
        outs = [run() for _ in range(5)]
        torch.cuda.synchronize()
        for out in outs[1:]:
            for a, b in zip(out, outs[0]):
                assert torch.equal(a, b), run.__name__
    o_s, lse_s = split()
    o_p, lse_p = flash_fwd.flash_attn_forward_plain(*xs, lens_s, causal=True,
                                                    softmax_scale=D ** -0.5)
    t32 = [x.float() for x in xs]
    o32, _ = flash_fwd.flash_attn_forward_plain(*t32, lens_s, causal=True, softmax_scale=D ** -0.5)
    _check(o_s, o32, o_p, torch.bfloat16)
    assert (lse_s - lse_p).abs().max().item() <= 1e-4


@pytest.mark.parametrize("D", [640, 1024])
@pytest.mark.parametrize("S,Hkv,jax_route", [(256, 8, "tri_square"), (1024, 8, "worklist"),
                                             (2048, 2, "generic")])
def test_wider_head_dims_take_the_pair(dev, prior_routes, D, S, Hkv, jax_route):
    """The public call, bf16, B 2 x 8 query heads: past D 512 the backward
    takes the dq + dk/dv pair, also where JAX's gates send it to a fused
    schedule (the tri-square at S 256, the work list at S 1024, MHA; not
    built past 512 yet), one launch each and no schedule; the forward one
    launch of its route; the FA rules against the fp32 plain twins."""
    g = torch.Generator(device=dev).manual_seed(D + S)
    x32 = [torch.randn(2, S, h, D, generator=g, device=dev) * 0.5 for h in (8, Hkv, Hkv)]
    do32 = torch.randn(2, S, 8, D, generator=g, device=dev)
    gates = flash_bwd.backward_gates(S, S, D, 2, causal=True, group=8 // Hkv, static_skip=True)
    assert jax_route == "generic" or gates[jax_route]
    assert flash_bwd.backward_route(S, S, D, 2, causal=True, group=8 // Hkv,
                                    static_skip=True) in ("generic", "strip")
    leaves = [x.to(torch.bfloat16).requires_grad_() for x in x32]
    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    out = flash_attn_func(*leaves, causal=True)
    out.backward(do32.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert flash_fwd.LAUNCHES + sum(flash_fwd.SCHEDULE_LAUNCHES.values()) == 1
    assert flash_bwd.LAUNCHES == {"flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}
    assert not any(flash_bwd.SCHEDULE_LAUNCHES.values())
    t = lambda x: x.transpose(1, 2)
    lens = torch.tensor([[S, S]] * 2, dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
    refs = flash_bwd.flash_attn_backward_plain(*(t(x) for x in x32), t(do32), o32, lse32, lens,
                                               **kw)
    xl = [t(x.detach()) for x in leaves]
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(*xl, lens, **kw)
    plains = flash_bwd.flash_attn_backward_plain(*xl, t(do32.to(torch.bfloat16)), o_pl, lse_pl,
                                                 lens, **kw)
    _check(t(out.detach()), o32, o_pl, torch.bfloat16)
    _check_grads([t(x.grad) for x in leaves], refs, plains, torch.bfloat16)
