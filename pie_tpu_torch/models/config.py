"""Model configuration parsing.

Reference parity: pydantic ``BaseModelArgs`` with ``extra="ignore"``
(models/base.py:10-16) and per-arch ModelArgs (models/llama/language.py:13-29),
as plain dataclasses built from HF ``config.json`` dicts.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Weight quantization block from config.json (reference models/utils.py:96)."""

    group_size: int = 64
    bits: int = 4

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["QuantizationConfig"]:
        if not d:
            return None
        return cls(group_size=int(d.get("group_size", 64)), bits=int(d.get("bits", 4)))


def _filter_kwargs(cls, d: dict[str, Any]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    model_type: str = "llama"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "BaseConfig":
        return cls(**_filter_kwargs(cls, d))

    @classmethod
    def from_json(cls, path: str | Path) -> "BaseConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_config_dict(model_path: str | Path) -> dict[str, Any]:
    with open(Path(model_path) / "config.json") as f:
        return json.load(f)
