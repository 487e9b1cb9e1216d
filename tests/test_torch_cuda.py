"""CUDA kernels of the PyTorch port against their plain PyTorch twins, on
the card. Marked `cuda`: without a GPU every test here skips. On a machine
with one (no JAX needed):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: fp32 kernel vs fp32 plain 1e-4 max abs (summation order only);
fp16/bf16 kernel error vs the fp32 plain at most 2x the low-precision plain
version's own error + 5e-5 (the FA rule of tests/utils.py:19-20); base-2
lse 1e-4 (fp32 math on both sides).
"""
import pytest

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import decode, flash_fwd  # noqa: E402
from fa2_triton_tpu_torch.ops.attention import flash_attn_func  # noqa: E402

pytestmark = pytest.mark.cuda


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
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
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
    q = torch.zeros(1, 8, 2, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn_func(q, q, q, causal=True)
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        flash_attn_func(q, q, q, causal=True)
    q = torch.zeros(1, 8, 2, 64, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attn_func(q, q, q, causal=True)
    qd = torch.zeros(2, 6, 64, device=dev)
    cache = torch.zeros(2, 2, 128, 64, device=dev)
    with pytest.raises(ValueError, match="Hq / Hkv"):
        decode.decode_attention(qd, cache, cache, torch.ones(2, dtype=torch.int32, device=dev))


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
