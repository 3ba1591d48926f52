"""Root state machine: maps request parameters to constrained-decoding
states.

Reference parity: RootStateMachine._create_state_graph (reference
state_machine/root.py:66-125): response_format json_schema ->
StructuredOutputState; json_object -> empty-schema JSON; tools ->
ToolCallState (single, or array-of-oneOf for parallel calls; tool_choice
'required'/named function filtering); text -> freeform with stop sequences.
Per-state generation kwargs: tool calls force temperature 0.0 / min_p 0.02
(reference state_machine/sub_states/tool_call.py:57-59).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

from pie_tpu_torch.structured.json_machine import JsonMachine


@dataclasses.dataclass
class StructuredState:
    name: str  # "text" | "structured_output" | "tool_call" | "reasoning"
    machine: Optional[JsonMachine] = None  # None = freeform
    generation_kwargs: dict = dataclasses.field(default_factory=dict)
    stop_sequences: tuple[str, ...] = ()
    #: per-sub-state sampler overrides, keyed by the composite machine's
    #: active part names (reference keys samplers off the live PSE state
    #: each step, engine/inference_engine.py:257-271 + per-state kwargs
    #: state_machine/sub_state.py:12-21): a reasoning phase samples
    #: freeform while the tool_call phase that follows forces temp 0
    state_kwargs: dict = dataclasses.field(default_factory=dict)


def _tool_schema(tool: dict) -> dict:
    fn = tool.get("function", tool)
    return {
        "type": "object",
        "properties": {
            "name": {"enum": [fn["name"]]},
            "arguments": fn.get("parameters") or {"type": "object"},
        },
        "required": ["name", "arguments"],
        "additionalProperties": False,
    }


class RootStateMachine:
    """Builds the active constrained state for a request."""

    def __init__(self, control_tokens=None):
        self.control_tokens = control_tokens
        self.state: Optional[StructuredState] = None

    #: think-tag pair used when a request asks for a reasoning state
    REASONING_TAGS = ("<think>", "</think>")

    def configure(
        self,
        response_format: Optional[dict] = None,
        tools: Optional[Sequence[dict]] = None,
        tool_choice: Any = "auto",
        parallel_tool_calls: bool = False,
        stop: Sequence[str] = (),
        reasoning: bool = False,
    ) -> StructuredState:
        """Build the active constrained state. ``reasoning=True`` prepends a
        <think>...</think> state ahead of whatever output state the rest of
        the parameters select (reference ReasoningState composed into the
        root graph, state_machine/sub_states/__init__.py:1-13 +
        root.py:66-125)."""
        stop = tuple(stop or ())
        fmt_type = (response_format or {}).get("type", "text")

        if tools and tool_choice not in (None, "none", "auto"):
            selected = list(tools)
            if isinstance(tool_choice, dict):
                name = (
                    tool_choice.get("function", {}).get("name")
                    or tool_choice.get("name")
                )
                selected = [
                    t for t in tools
                    if (t.get("function", t).get("name")) == name
                ]
                if not selected:
                    raise ValueError(f"unknown tool in tool_choice: {name}")
            schemas = [_tool_schema(t) for t in selected]
            one = schemas[0] if len(schemas) == 1 else {"oneOf": schemas}
            if parallel_tool_calls:
                schema = {"type": "array", "items": one, "minItems": 1}
            else:
                schema = one
            self.state = StructuredState(
                name="tool_call",
                machine=JsonMachine(schema),
                generation_kwargs={"temperature": 0.0, "min_p": 0.02},
                state_kwargs={"tool_call": {"temperature": 0.0, "min_p": 0.02}},
            )
        elif fmt_type == "json_schema":
            spec = response_format.get("json_schema", {}) or {}
            schema = spec.get("schema") or spec.get("schema_") or {}
            self.state = StructuredState(
                name="structured_output", machine=JsonMachine(schema)
            )
        elif fmt_type == "json_object":
            self.state = StructuredState(
                name="structured_output",
                machine=JsonMachine({"type": "object"}),
            )
        else:
            self.state = StructuredState(name="text", stop_sequences=stop)
        if reasoning:
            from pie_tpu_torch.structured.machines import reasoning_machine

            open_tag, close_tag = self.REASONING_TAGS
            inner = self.state
            self.state = StructuredState(
                name=f"reasoning+{inner.name}",
                machine=reasoning_machine(
                    inner.machine, open_tag, close_tag,
                    stop=inner.stop_sequences or (self._end_of_turn(),),
                    output_name=inner.name,
                ),
                # the inner state's forced kwargs apply ONLY while its part
                # of the composite is active — the <think> phase samples at
                # the request's own parameters
                generation_kwargs={},
                stop_sequences=inner.stop_sequences,
                state_kwargs=(
                    {inner.name: inner.generation_kwargs}
                    if inner.generation_kwargs
                    else dict(inner.state_kwargs)
                ),
            )
        return self.state

    def _end_of_turn(self) -> str:
        if self.control_tokens is not None:
            return self.control_tokens.end_of_turn
        return "</s>"

    @staticmethod
    def split_reasoning(state: StructuredState, text: str):
        """(reasoning_content, visible_text) for reasoning states;
        (None, text) otherwise."""
        if not state.name.startswith("reasoning+"):
            return None, text
        open_tag, close_tag = RootStateMachine.REASONING_TAGS
        body = text
        if body.startswith(open_tag):
            body = body[len(open_tag):]
        i = body.find(close_tag)
        if i == -1:
            return body, ""
        return body[:i], body[i + len(close_tag):]

    # -- output labeling (reference get_labeled_output) ------------------

    @staticmethod
    def labeled_output(state: StructuredState, text: str):
        """Parse the raw generated text according to the state; returns
        (label, value). Reasoning states strip the <think> block before
        labeling the remainder (reference get_labeled_output semantics)."""
        if state.name.startswith("reasoning+"):
            open_tag, close_tag = RootStateMachine.REASONING_TAGS
            i = text.find(close_tag)
            if i != -1:
                text = text[i + len(close_tag):]
            inner = dataclasses.replace(
                state, name=state.name.split("+", 1)[1]
            )
            return RootStateMachine.labeled_output(inner, text)
        if state.machine is None:
            return "text", text
        try:
            value = json.loads(text)
        except json.JSONDecodeError:
            return "text", text
        if state.name == "tool_call":
            calls = value if isinstance(value, list) else [value]
            return "tool_calls", [
                {"name": c.get("name"), "arguments": c.get("arguments", {})}
                for c in calls
                if isinstance(c, dict)
            ]
        return "json", value
