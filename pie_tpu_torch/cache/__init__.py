"""KV cache family: contiguous, rotating (sliding-window), quantized, and
cross-request prompt caching."""

from pie_tpu_torch.cache.kv_cache import (
    KVCache,
    QuantizedKVCache,
    make_kv_cache,
)
