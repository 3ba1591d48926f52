"""Architecture registry.

Reference parity: the dynamic-import registry + aliasing of
models/utils.py:128-161 (gemma3->gemma, mistral->llama etc), re-done as an
explicit decorator registry (self-contained — no external model-zoo fallback,
per SURVEY.md §2.4).
"""

from __future__ import annotations

import importlib
from typing import Callable

_REGISTRY: dict[str, str] = {}

# model_type aliases (reference models/utils.py:139-147)
_ALIASES = {
    "mistral": "llama",
    "llama": "llama",
    "gemma3": "gemma3",
    "gemma3_text": "gemma3",
    "qwen2_vl": "qwen2_vl",
    "qwen2_5_vl": "qwen2_vl",
    "qwen2": "qwen2",
}


def register_model(model_type: str) -> Callable:
    def deco(cls):
        _REGISTRY[model_type] = cls
        return cls

    return deco


def get_model_class(model_type: str):
    canonical = _ALIASES.get(model_type, model_type)
    # Import the module to trigger registration.
    try:
        importlib.import_module(f"pie_tpu_torch.models.{canonical}")
    except ImportError as e:
        raise ValueError(
            f"Unsupported model architecture {model_type!r}: {e}"
        ) from e
    if canonical not in _REGISTRY:
        raise ValueError(f"Unsupported model architecture {model_type!r}")
    return _REGISTRY[canonical]
