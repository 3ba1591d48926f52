"""Cross-request prompt caching: in-memory prefix reuse + disk persistence.

Port of the JAX package's ``pie_tpu/cache/prompt_cache.py``: track the
computed token ids, reuse the cache for the common prefix and prefill only
the suffix (a metadata trim of the fixed-capacity cache), and persist
caches to safetensors keyed by SHA-256 of the token ids, in the same file
format (bf16 tensors stored as f32 and listed in the metadata; both groups
of a DualKVCache).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from pie_tpu_torch.cache.kv_cache import DualKVCache, KVCache, QuantizedKVCache

_CACHE_CLASSES = {"KVCache": KVCache, "QuantizedKVCache": QuantizedKVCache}
_DUAL_GROUPS = ("sliding", "full")


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


def _collect_tensors(cache, tensors: dict, meta: dict, prefix: str = ""):
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        if isinstance(v, torch.Tensor):
            name = prefix + f.name
            if v.dtype == torch.bfloat16:
                meta.setdefault("bf16_fields", []).append(name)
                v = v.to(torch.float32)
            tensors[name] = np.ascontiguousarray(v.cpu().numpy())


def save_cache(cache, path: str | Path, extra_meta: Optional[dict] = None):
    """A cache to safetensors in the JAX package's format: a DualKVCache's
    groups under ``sliding.`` / ``full.`` with their classes and windows in
    the metadata."""
    from safetensors.numpy import save_file

    tensors = {}
    meta = {"cache_class": type(cache).__name__}
    if extra_meta:
        meta.update(extra_meta)
    if isinstance(cache, DualKVCache):
        for group in _DUAL_GROUPS:
            sub = getattr(cache, group)
            meta[group + "_class"] = type(sub).__name__
            meta[group + "_window"] = sub.window
            _collect_tensors(sub, tensors, meta, group + ".")
    else:
        meta["window"] = cache.window
        _collect_tensors(cache, tensors, meta)
    save_file(tensors, str(path), metadata={"pie": json.dumps(meta)})


def _build_cache(name, data, bf16, window, device, prefix=""):
    cls = _CACHE_CLASSES.get(name)
    if cls is None:
        raise ValueError(f"cache class {name!r} is not ported")
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if key in data:
            t = torch.from_numpy(data[key]).to(device)
            kwargs[f.name] = t.to(torch.bfloat16) if key in bf16 else t
    kwargs["window"] = window
    return cls(**kwargs)


def load_cache(path: str | Path, device):
    from safetensors import safe_open
    from safetensors.numpy import load_file

    with safe_open(str(path), framework="np") as f:
        meta = json.loads((f.metadata() or {}).get("pie", "{}"))
    data = load_file(str(path))
    bf16 = set(meta.get("bf16_fields", []))
    if meta.get("cache_class") == "DualKVCache":
        groups = {g: _build_cache(meta.get(g + "_class", "KVCache"), data, bf16,
                                  meta.get(g + "_window"), device, g + ".")
                  for g in _DUAL_GROUPS}
        return DualKVCache(**groups), meta
    return _build_cache(meta.get("cache_class", "KVCache"), data, bf16,
                        meta.get("window"), device), meta
