"""Thin sync SDK over an engine: the request models and a client that
turns a request into a chat.

The port's copy of the JAX package's ``pie_tpu/engine/client.py`` (reference
engine/client.py:11-87), its imports rewritten to the port's
``interaction/``."""

from __future__ import annotations

from typing import Any, Optional, Union

from pydantic import BaseModel, ConfigDict, Field

from pie_tpu_torch.interaction import Interaction, InteractionRole


class GenerationKwargs(BaseModel):
    """Free-form sampling/processor knobs (reference engine/client.py:76-87)."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    min_p: float = 0.0
    repetition_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    logit_bias: Optional[dict[int, float]] = None
    max_completion_tokens: int = 1024
    seed: Optional[int] = None
    model_config = ConfigDict(extra="allow")


class GenerationRequest(BaseModel):
    """High-level request (reference engine/client.py:36-73)."""

    prompt: Optional[str] = None
    system: Optional[str] = None
    messages: Optional[list[dict[str, Any]]] = None
    tools: Optional[list[dict[str, Any]]] = None
    response_format: Optional[dict[str, Any]] = None
    stop: Optional[Union[str, list[str]]] = None
    kwargs: GenerationKwargs = Field(default_factory=GenerationKwargs)

    def to_interactions(self) -> list[Interaction]:
        out: list[Interaction] = []
        if self.system:
            out.append(Interaction.simple(InteractionRole.SYSTEM, self.system))
        if self.messages:
            for m in self.messages:
                out.append(
                    Interaction.simple(m["role"], m.get("content", m.get("text", "")))
                )
        if self.prompt:
            out.append(Interaction.simple(InteractionRole.USER, self.prompt))
        if not out:
            raise ValueError("request has no prompt or messages")
        return out


class InferenceEngineClient:
    """Sync client wrapping a local engine (reference engine/client.py:11-33)."""

    def __init__(self, engine):
        self.engine = engine

    def generate(self, request: GenerationRequest) -> Interaction:
        interactions = request.to_interactions()
        kw = request.kwargs.model_dump(exclude_none=True)
        max_tokens = kw.pop("max_completion_tokens", 1024)
        kw.pop("seed", None)
        return self.engine.chat(
            interactions,
            tools=request.tools,
            response_format=request.response_format,
            stop=request.stop,
            max_completion_tokens=max_tokens,
            **{k: v for k, v in kw.items() if v is not None},
        )
