from fa2_triton_tpu_torch.runtime.kv_cache import KVCacheConfig, init_cache, write_kv
from fa2_triton_tpu_torch.runtime.paged_cache import (
    PagedCacheConfig, PagedKVCache, write_tokens_paged,
)
from fa2_triton_tpu_torch.runtime.sampling import SamplingParams
from fa2_triton_tpu_torch.runtime.serving import Engine, EngineStats, Request

__all__ = ["KVCacheConfig", "init_cache", "write_kv", "PagedCacheConfig", "PagedKVCache",
           "write_tokens_paged", "Engine", "Request", "EngineStats", "SamplingParams"]
