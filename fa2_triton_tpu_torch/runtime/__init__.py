from fa2_triton_tpu_torch.runtime.kv_cache import KVCacheConfig, init_cache, write_kv
from fa2_triton_tpu_torch.runtime.paged_cache import (
    PagedCacheConfig, PagedKVCache, write_tokens_paged,
)
from fa2_triton_tpu_torch.runtime.sampling import SamplingParams
from fa2_triton_tpu_torch.runtime.serving import DataParallelEngine, Engine, EngineStats, Request
from fa2_triton_tpu_torch.runtime.speculative import SpeculativeDecoder

__all__ = ["KVCacheConfig", "init_cache", "write_kv", "PagedCacheConfig", "PagedKVCache",
           "write_tokens_paged", "Engine", "DataParallelEngine", "Request", "EngineStats", "SamplingParams",
           "SpeculativeDecoder"]
