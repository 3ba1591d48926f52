"""Inference engine: prefill/decode core + host orchestration."""

from pie_tpu_torch.engine.core import DecodeState, EngineCore, PenaltyParams
from pie_tpu_torch.engine.engine import GenerationResult, InferenceEngine
