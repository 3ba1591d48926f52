"""OpenAI-wire pydantic schemas.

Reference parity: server/models/ (P19 in SURVEY.md §2.1) — chat request with
non-standard ``top_k``/``min_p`` extensions, response/chunk/choice/usage,
logprobs with bytes + top_logprobs, tools + tool_choice modes,
response_format text/json_object/json_schema, completions models, and the
Responses-API surface. These are public OpenAI API shapes.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Literal, Optional, Union

from pydantic import BaseModel, ConfigDict, Field


def _id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def _now() -> int:
    return int(time.time())


# -- shared -----------------------------------------------------------------


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class FunctionDef(BaseModel):
    name: str
    description: Optional[str] = None
    parameters: Optional[dict[str, Any]] = None
    strict: Optional[bool] = None


class ToolDef(BaseModel):
    type: Literal["function"] = "function"
    function: FunctionDef


class NamedToolChoice(BaseModel):
    type: Literal["function"] = "function"
    function: dict[str, str]


ToolChoice = Union[Literal["none", "auto", "required"], NamedToolChoice]


class ResponseFormatText(BaseModel):
    type: Literal["text"] = "text"


class ResponseFormatJsonObject(BaseModel):
    type: Literal["json_object"] = "json_object"


class JsonSchemaSpec(BaseModel):
    name: str = "response"
    description: Optional[str] = None
    schema_: Optional[dict[str, Any]] = Field(default=None, alias="schema")
    strict: Optional[bool] = None
    model_config = ConfigDict(populate_by_name=True)


class ResponseFormatJsonSchema(BaseModel):
    type: Literal["json_schema"] = "json_schema"
    json_schema: JsonSchemaSpec


ResponseFormat = Union[
    ResponseFormatText, ResponseFormatJsonObject, ResponseFormatJsonSchema
]


# -- chat -------------------------------------------------------------------


class ChatMessage(BaseModel):
    role: Literal["system", "user", "assistant", "tool", "developer"]
    content: Optional[Union[str, list[dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[list[dict[str, Any]]] = None
    tool_call_id: Optional[str] = None

    def text(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if isinstance(self.content, list):
            return "".join(
                p.get("text", "") for p in self.content if p.get("type") == "text"
            )
        return ""

    def images(self) -> list[str]:
        """Image sources from ``image_url`` content parts (OpenAI vision
        wire shape: {"type": "image_url", "image_url": {"url": ...}})."""
        if not isinstance(self.content, list):
            return []
        out = []
        for p in self.content:
            if p.get("type") != "image_url":
                continue
            u = p.get("image_url")
            url = u.get("url") if isinstance(u, dict) else u
            if url:
                out.append(url)
        return out


class StreamOptions(BaseModel):
    include_usage: bool = False


class ChatCompletionRequest(BaseModel):
    model: str = "default"
    messages: list[ChatMessage]
    temperature: Optional[float] = 1.0
    top_p: Optional[float] = 1.0
    top_k: Optional[int] = None  # non-standard (reference request.py:84-166)
    min_p: Optional[float] = None  # non-standard
    # XTC sampler + DRY penalty (reference ships 0-byte placeholders)
    xtc_probability: Optional[float] = None
    xtc_threshold: Optional[float] = None
    dry_multiplier: Optional[float] = None
    dry_base: Optional[float] = None
    dry_allowed_length: Optional[int] = None
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    n: int = 1
    stop: Optional[Union[str, list[str]]] = None
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    repetition_penalty: Optional[float] = None  # non-standard
    logit_bias: Optional[dict[str, float]] = None
    logprobs: Optional[bool] = False
    top_logprobs: Optional[int] = None
    seed: Optional[int] = None
    user: Optional[str] = None
    tools: Optional[list[ToolDef]] = None
    tool_choice: Optional[ToolChoice] = None
    parallel_tool_calls: Optional[bool] = True
    response_format: Optional[ResponseFormat] = None
    # non-standard: constrain output to a <think>...</think> block followed
    # by the response (reference ReasoningState); the think body comes back
    # in message.reasoning_content
    reasoning: Optional[bool] = False
    model_config = ConfigDict(extra="ignore")


class TopLogprobEntry(BaseModel):
    token: str
    logprob: float
    bytes: Optional[list[int]] = None


class TokenLogprobOut(BaseModel):
    token: str
    logprob: float
    bytes: Optional[list[int]] = None
    top_logprobs: list[TopLogprobEntry] = Field(default_factory=list)


class ChoiceLogprobs(BaseModel):
    content: Optional[list[TokenLogprobOut]] = None


class ChatToolCall(BaseModel):
    id: str = Field(default_factory=lambda: _id("call"))
    type: Literal["function"] = "function"
    function: dict[str, Any]


class ChatResponseMessage(BaseModel):
    role: Literal["assistant"] = "assistant"
    content: Optional[str] = None
    reasoning_content: Optional[str] = None
    tool_calls: Optional[list[ChatToolCall]] = None


class ChatChoice(BaseModel):
    index: int = 0
    message: ChatResponseMessage
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogprobs] = None


class ChatCompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: _id("chatcmpl"))
    object: Literal["chat.completion"] = "chat.completion"
    created: int = Field(default_factory=_now)
    model: str = "default"
    choices: list[ChatChoice]
    usage: Optional[Usage] = None


class ChunkDelta(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None
    tool_calls: Optional[list[dict[str, Any]]] = None


class ChunkChoice(BaseModel):
    index: int = 0
    delta: ChunkDelta
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogprobs] = None


class ChatCompletionChunk(BaseModel):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int = Field(default_factory=_now)
    model: str = "default"
    choices: list[ChunkChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None


# -- completions ------------------------------------------------------------


class CompletionRequest(BaseModel):
    model: str = "default"
    prompt: Union[str, list[str], list[int]]
    suffix: Optional[str] = None
    max_tokens: Optional[int] = 16
    temperature: Optional[float] = 1.0
    top_p: Optional[float] = 1.0
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    xtc_probability: Optional[float] = None
    xtc_threshold: Optional[float] = None
    dry_multiplier: Optional[float] = None
    dry_base: Optional[float] = None
    dry_allowed_length: Optional[int] = None
    n: int = 1
    best_of: Optional[int] = None
    stream: bool = False
    logprobs: Optional[int] = None
    echo: bool = False
    stop: Optional[Union[str, list[str]]] = None
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    repetition_penalty: Optional[float] = None
    logit_bias: Optional[dict[str, float]] = None
    seed: Optional[int] = None
    user: Optional[str] = None
    model_config = ConfigDict(extra="ignore")


class CompletionLogprobs(BaseModel):
    tokens: list[str] = Field(default_factory=list)
    token_logprobs: list[Optional[float]] = Field(default_factory=list)
    top_logprobs: list[Optional[dict[str, float]]] = Field(default_factory=list)
    text_offset: list[int] = Field(default_factory=list)


class CompletionChoice(BaseModel):
    index: int = 0
    text: str
    finish_reason: Optional[str] = None
    logprobs: Optional[CompletionLogprobs] = None


class CompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: _id("cmpl"))
    object: Literal["text_completion"] = "text_completion"
    created: int = Field(default_factory=_now)
    model: str = "default"
    choices: list[CompletionChoice]
    usage: Optional[Usage] = None


# -- responses API (MVP text + function-call output, reference
#    server/routes/responses.py:34-131) ------------------------------------


class ResponsesRequest(BaseModel):
    model: str = "default"
    input: Union[str, list[dict[str, Any]]]
    instructions: Optional[str] = None
    max_output_tokens: Optional[int] = None
    temperature: Optional[float] = 1.0
    top_p: Optional[float] = 1.0
    stream: bool = False
    tools: Optional[list[dict[str, Any]]] = None
    tool_choice: Optional[Any] = None
    text: Optional[dict[str, Any]] = None  # {"format": {...}}
    model_config = ConfigDict(extra="ignore")


class ResponsesOutputText(BaseModel):
    type: Literal["output_text"] = "output_text"
    text: str
    annotations: list[Any] = Field(default_factory=list)


class ResponsesMessage(BaseModel):
    type: Literal["message"] = "message"
    id: str = Field(default_factory=lambda: _id("msg"))
    role: Literal["assistant"] = "assistant"
    status: str = "completed"
    content: list[ResponsesOutputText] = Field(default_factory=list)


class ResponsesFunctionCall(BaseModel):
    type: Literal["function_call"] = "function_call"
    id: str = Field(default_factory=lambda: _id("fc"))
    call_id: str = Field(default_factory=lambda: _id("call"))
    name: str
    arguments: str = "{}"
    status: str = "completed"


class ResponsesUsage(BaseModel):
    input_tokens: int = 0
    output_tokens: int = 0
    total_tokens: int = 0


class ResponsesResponse(BaseModel):
    id: str = Field(default_factory=lambda: _id("resp"))
    object: Literal["response"] = "response"
    created_at: int = Field(default_factory=_now)
    status: str = "completed"
    model: str = "default"
    output: list[Union[ResponsesMessage, ResponsesFunctionCall]] = Field(
        default_factory=list
    )
    usage: Optional[ResponsesUsage] = None


class ErrorBody(BaseModel):
    message: str
    type: str = "invalid_request_error"
    param: Optional[str] = None
    code: Optional[str] = None


class ErrorResponse(BaseModel):
    error: ErrorBody
