"""Server settings from environment / .env (reference server/config.py:4-19).

Only the settings the port reads are kept. The reference's MAX_SEQ_LEN,
KV_QUANTIZED, NUM_LANES, NUM_PAGES and NATIVE_SCHEDULER configure the
engine that the model loader builds, which is not ported yet (ROADMAP
queues A9 and A7): ``create_app`` refuses MODEL_PATH, takes the engine from
its caller, and refuses BATCHING=1 with a single-stream engine."""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class Settings:
    model_path: Optional[str] = None
    host: str = "0.0.0.0"
    port: int = 8000
    log_level: str = "INFO"
    batching: bool = False

    @classmethod
    def load(cls) -> "Settings":
        env_file = Path(".env")
        env: dict[str, str] = {}
        if env_file.exists():
            for line in env_file.read_text().splitlines():
                line = line.strip()
                if line and not line.startswith("#") and "=" in line:
                    k, v = line.split("=", 1)
                    env[k.strip()] = v.strip()
        get = lambda k, d=None: os.environ.get(k, env.get(k, d))
        return cls(
            model_path=get("MODEL_PATH"),
            host=get("HOST", "0.0.0.0"),
            port=int(get("PORT", "8000")),
            log_level=get("LOG_LEVEL", "INFO"),
            batching=get("BATCHING", "0") in ("1", "true", "True"),
        )


_settings: Optional[Settings] = None


def get_settings() -> Settings:
    global _settings
    if _settings is None:
        _settings = Settings.load()
    return _settings
