"""The port's constructors build on the GPU unless the caller names a
device (`fa2_triton_tpu_torch.utils.resolve_device`): with no GPU, a
constructor called without a device raises instead of quietly building on
the CPU, and with `device="cpu"` it builds there. `torch.cuda.is_available`
is patched, so the tests say the same on a machine with a card."""
import pytest

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch import FlashSelfAttention  # noqa: E402
from fa2_triton_tpu_torch.layers import flash_self_attention_from_flax  # noqa: E402
from fa2_triton_tpu_torch.models import LlamaConfig, init_params  # noqa: E402
from fa2_triton_tpu_torch.models.convert import (  # noqa: E402
    llama_from_jax_params, llama_to_jax_params)
from fa2_triton_tpu_torch.models.llama import LlamaLayer, LlamaModel  # noqa: E402
from fa2_triton_tpu_torch.runtime.kv_cache import KVCacheConfig, init_cache  # noqa: E402
from fa2_triton_tpu_torch.runtime.paged_cache import PagedCacheConfig, PagedKVCache  # noqa: E402
from fa2_triton_tpu_torch.utils import resolve_device  # noqa: E402

CFG = LlamaConfig(vocab_size=32, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=32,
                  dtype=torch.float32)


def _jax_tree():
    # init_params takes its device from the generator: a CPU one here.
    return llama_to_jax_params(init_params(torch.Generator().manual_seed(0), CFG))


def _flax_params():
    layer = FlashSelfAttention(32, 2, device="cpu")
    tree = {}
    for name, value in layer.state_dict().items():
        mod, leaf = name.split(".")
        tree.setdefault(mod, {})[leaf] = value.numpy()
    return {"params": tree}


# name -> (build(**device_kw), the tensors it made)
BUILDERS = {
    "llama_from_jax_params": (lambda **kw: llama_from_jax_params(_jax_tree(), CFG, **kw),
                              lambda m: list(m.parameters())),
    "LlamaModel": (lambda **kw: LlamaModel(CFG, **kw), lambda m: list(m.parameters())),
    "LlamaLayer": (lambda **kw: LlamaLayer(CFG, **kw), lambda m: list(m.parameters())),
    "FlashSelfAttention": (lambda **kw: FlashSelfAttention(32, 2, causal=True, **kw),
                           lambda m: list(m.parameters())),
    "flash_self_attention_from_flax": (
        lambda **kw: flash_self_attention_from_flax(_flax_params(), 32, num_heads=2, **kw),
        lambda m: list(m.parameters())),
    "init_cache": (lambda **kw: init_cache(KVCacheConfig(n_layers=1, n_kv_heads=1, head_dim=8,
                                                         max_seq=128, n_slots=1), **kw),
                   lambda c: [t for layer in c for t in layer.values()]),
    "PagedKVCache": (lambda **kw: PagedKVCache(PagedCacheConfig(
        n_layers=1, n_kv_heads=1, head_dim=8, page_size=128, n_pages=4, n_slots=1, max_seq=256,
        qdtype=torch.int8), **kw),
        lambda c: [t for layer in c.pools for t in layer.values()]),
}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_no_device_without_gpu_raises(no_gpu, name):
    build, _ = BUILDERS[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_cpu_device_builds_on_cpu(no_gpu, name):
    build, tensors = BUILDERS[name]
    made = tensors(build(device="cpu"))
    assert made and all(t.device.type == "cpu" for t in made)


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
