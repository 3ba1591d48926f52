"""Cross-request prompt caching: in-memory prefix reuse + disk persistence.

Port of the JAX package's ``pie_tpu/cache/prompt_cache.py``: track the
computed token ids, reuse the cache for the common prefix and prefill only
the suffix (a metadata trim of the fixed-capacity cache), and persist
caches to safetensors keyed by SHA-256 of the token ids, in the same file
format (bf16 tensors stored as f32 and listed in the metadata).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from pie_tpu_torch.cache.kv_cache import KVCache, QuantizedKVCache

_CACHE_CLASSES = {"KVCache": KVCache, "QuantizedKVCache": QuantizedKVCache}


def common_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PromptCache:
    """Per-engine prompt cache."""

    def __init__(self, cache_dir: Optional[str | Path] = None):
        self.computed_ids: list[int] = []
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def reuse_prefix(self, prompt_ids: Sequence[int]) -> int:
        """Leading prompt tokens whose KV is already in the engine cache;
        always leaves >= 1 token to prefill (its logits are needed)."""
        cp = common_prefix_len(self.computed_ids, prompt_ids)
        return max(0, min(cp, len(prompt_ids) - 1))

    def update(self, ids: Sequence[int]):
        self.computed_ids = list(ids)

    @staticmethod
    def prompt_hash(ids: Sequence[int]) -> str:
        h = hashlib.sha256()
        h.update(np.asarray(list(ids), np.int64).tobytes())
        return h.hexdigest()

    def cache_path(self, ids: Sequence[int]) -> Optional[Path]:
        if not self.cache_dir:
            return None
        return self.cache_dir / f"{self.prompt_hash(ids)}.safetensors"

    def save_prompt(self, ids: Sequence[int], cache) -> Optional[Path]:
        path = self.cache_path(ids)
        if path is None:
            return None
        save_cache(cache, path, extra_meta={"computed_ids": list(map(int, ids))})
        return path

    def load_prompt(self, ids: Sequence[int], device):
        """Returns (cache, computed_ids) or None on miss."""
        path = self.cache_path(ids)
        if path is None or not path.exists():
            return None
        cache, meta = load_cache(path, device=device)
        return cache, meta.get("computed_ids", [])


def save_cache(cache, path: str | Path, extra_meta: Optional[dict] = None):
    from safetensors.numpy import save_file

    tensors = {}
    meta = {"cache_class": type(cache).__name__, "window": cache.window}
    if extra_meta:
        meta.update(extra_meta)
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                meta.setdefault("bf16_fields", []).append(f.name)
                v = v.to(torch.float32)
            tensors[f.name] = np.ascontiguousarray(v.cpu().numpy())
    save_file(tensors, str(path), metadata={"pie": json.dumps(meta)})


def load_cache(path: str | Path, device):
    from safetensors import safe_open
    from safetensors.numpy import load_file

    with safe_open(str(path), framework="np") as f:
        meta = json.loads((f.metadata() or {}).get("pie", "{}"))
    cls = _CACHE_CLASSES.get(meta.get("cache_class", "KVCache"))
    if cls is None:
        raise ValueError(f"cache class {meta.get('cache_class')!r} is not ported")
    data = load_file(str(path))
    bf16 = set(meta.get("bf16_fields", []))
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            t = torch.from_numpy(data[f.name]).to(device)
            kwargs[f.name] = t.to(torch.bfloat16) if f.name in bf16 else t
    kwargs["window"] = meta.get("window")
    return cls(**kwargs), meta
