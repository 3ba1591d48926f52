"""Server settings from environment / .env (reference server/config.py:4-19).

MODEL_PATH names the checkpoint ``create_app`` loads; BATCHING=1 serves it
through the continuous-batching engine (NUM_LANES lanes over NUM_PAGES KV
pages), else through the single-stream engine (MAX_SEQ_LEN). KV_QUANTIZED
keeps the KV cache in INT8. NATIVE_SCHEDULER=1 asks for the C++ scheduler,
which is not ported yet (ROADMAP A7): the engine refuses it."""

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
    max_seq_len: int = 4096
    kv_quantized: bool = False
    batching: bool = False
    num_lanes: int = 8
    num_pages: int = 1024
    native_scheduler: bool = False

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
            max_seq_len=int(get("MAX_SEQ_LEN", "4096")),
            kv_quantized=get("KV_QUANTIZED", "0") in ("1", "true", "True"),
            batching=get("BATCHING", "0") in ("1", "true", "True"),
            num_lanes=int(get("NUM_LANES", "8")),
            num_pages=int(get("NUM_PAGES", "1024")),
            native_scheduler=get("NATIVE_SCHEDULER", "0") in ("1", "true", "True"),
        )


_settings: Optional[Settings] = None


def get_settings() -> Settings:
    global _settings
    if _settings is None:
        _settings = Settings.load()
    return _settings
