"""Package-level contracts of the PyTorch port: it never imports JAX, and
its kernel build raises a clear error without nvcc instead of silently
running a plain path."""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.ops import _build  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import fa2_triton_tpu_torch, fa2_triton_tpu_torch.ops, fa2_triton_tpu_torch.models\n"
        "import fa2_triton_tpu_torch.runtime, fa2_triton_tpu_torch.models.convert\n"
        "import fa2_triton_tpu_torch.ops.quant, fa2_triton_tpu_torch.utils\n"
        "import fa2_triton_tpu_torch.ops.flash_bwd, fa2_triton_tpu_torch.examples.train\n"
        "from fa2_triton_tpu_torch.models import LlamaConfig, init_params\n"
        "from fa2_triton_tpu_torch.runtime import Engine\n"
        "cfg = LlamaConfig(vocab_size=64, dim=64, n_layers=1, n_heads=2, n_kv_heads=1,\n"
        "                  hidden_dim=64, dtype=__import__('torch').float32)\n"
        "m = init_params(__import__('torch').Generator().manual_seed(0), cfg)\n"
        "e = Engine(m, cfg, n_slots=1, max_seq=128); e.submit([1, 2, 3], 2); e.run()\n"
        "e = Engine(m, cfg, n_slots=1, max_seq=256, paged=True, page_size=128,\n"
        "           qdtype=__import__('torch').int8); e.submit([1, 2, 3], 2); e.run()\n"
        "import fa2_triton_tpu_torch.ops.varlen\n"
        "from fa2_triton_tpu_torch import flash_attn_blocksparse_func, flash_attn_varlen_func\n"
        "x = __import__('torch').ones(256, 2, 64, requires_grad=True)\n"
        "flash_attn_varlen_func(x, x, x, [0, 128, 256], seqlens=[100, 7], causal=True,\n"
        "                       block_q=128, block_kv=128).sum().backward()\n"
        "flash_attn_blocksparse_func(x[None], x[None], x[None], [[True, False], [True, True]],\n"
        "                            causal=True, block_q=128, block_kv=128).sum().backward()\n"
        "import fa2_triton_tpu_torch.layers, fa2_triton_tpu_torch.utils.rng\n"
        "import fa2_triton_tpu_torch.utils.mask_probes, fa2_triton_tpu_torch.examples.kernel_times\n"
        "from fa2_triton_tpu_torch.models import GPT2Config, gpt2\n"
        "from fa2_triton_tpu_torch.runtime import SpeculativeDecoder\n"
        "g = GPT2Config(vocab_size=64, dim=64, n_layers=1, n_heads=1, hidden_dim=64,\n"
        "               max_seq_len=16, dtype=__import__('torch').float32)\n"
        "gm = gpt2.init_params(__import__('torch').Generator().manual_seed(0), g)\n"
        "gpt2.loss_fn(gm, __import__('torch').ones(1, 9, dtype=__import__('torch').long)).backward()\n"
        "SpeculativeDecoder(m, cfg, m, cfg, gamma=2, max_seq=64).generate([1, 2], 4)\n"
        "from fa2_triton_tpu_torch import FlashSelfAttention, flash_attn_func\n"
        "layer = FlashSelfAttention(64, 2, num_kv_heads=1, causal=True, use_rope=True,\n"
        "                           dropout_p=0.1, dropout_rng=__import__('torch').default_generator,\n"
        "                           device='cpu')\n"
        "layer(__import__('torch').ones(1, 8, 64)).sum().backward()\n"
        "flash_attn_func(x[None], x[None], x[None], dropout_p=0.2, dropout_seed=-3).sum().backward()\n"
        "import fa2_triton_tpu_torch.ops.tuning, fa2_triton_tpu_torch.ops.autotune\n"
        "from fa2_triton_tpu_torch.ops import microsweep\n"
        "assert microsweep.candidates('bwd_route', True, 128, 8192, 'g1')\n"
        "from fa2_triton_tpu_torch.other_implementations import dense_attention, flex_attention\n"
        "from fa2_triton_tpu_torch.other_implementations import sdpa_flash_attention\n"
        "y = x[None, :64].detach()\n"
        "for f in (dense_attention, sdpa_flash_attention, flex_attention): f(y, y, y, causal=True)\n"
        "import fa2_triton_tpu_torch.parallel.collectives, fa2_triton_tpu_torch.parallel.launch\n"
        "from fa2_triton_tpu_torch.parallel import make_ring_attention, make_ulysses_attention\n"
        "from fa2_triton_tpu_torch.parallel import make_tp_attention, fsdp_param_pspecs, shard_params\n"
        "from fa2_triton_tpu_torch.parallel.ring import zigzag_permute, zigzag_unpermute\n"
        "from fa2_triton_tpu_torch.runtime import DataParallelEngine\n"
        "assert zigzag_unpermute(zigzag_permute(x, 2, dim=0), 2, dim=0).equal(x)\n"
        "fsdp_param_pspecs(m, {'data': 2}, min_size=64)\n"
        "shard_params(m, {'data': 2}, fsdp_param_pspecs(m, {'data': 2}, min_size=64), {'data': 1})\n"
        "import fa2_triton_tpu_torch.parallel.pipeline, fa2_triton_tpu_torch.parallel.fsdp\n"
        "import fa2_triton_tpu_torch.parallel.dryrun\n"
        "from fa2_triton_tpu_torch.parallel.pipeline import make_pipeline, pipeline_params_from_llama\n"
        "from fa2_triton_tpu_torch.parallel.fsdp import FSDP, train_specs\n"
        "pp = pipeline_params_from_llama(m)\n"
        "assert pp['stacked']['wq'].shape[0] == cfg.n_layers\n"
        "from fa2_triton_tpu_torch.models.moe import make_ep_mlp, moe_param_pspecs\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'fa2_triton_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").rglob("*.so"))


def test_kernel_sources_are_hashed():
    names = {p.name for p in _build.sources()}
    assert {"flash_fwd.cu", "flash_bwd.cu", "decode.cu", "decode_int8.cu", "decode_fp8.cu",
            "varlen.cu", "common.cuh", "attn_tiles.cuh", "decode.cuh", "flash_bwd_tri.cu", "flash_bwd_wl.cu", "bwd_fused.cuh",
            "bwd_mma.cuh", "mma_tiles.cuh"} <= names
    assert len(_build.source_hash()) == 16
