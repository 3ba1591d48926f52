"""Model-agnostic chat template driven by the control-token registry.

Reference parity: tokenizer/chat_template.jinja:1-54 — one generic Jinja
template parameterized by per-family control tokens instead of per-model
templates baked into checkpoints.
"""

from __future__ import annotations

from typing import Any, Optional

from pie_tpu_torch.tokenizer.control_tokens import ControlTokens

_TEMPLATE = """\
{%- if bos %}{{ bos }}{% endif -%}
{%- for m in messages -%}
{{ role_start }}{{ m.role }}{{ role_end }}{{ m.text }}{{ end_of_turn }}{{ turn_sep }}
{%- endfor -%}
{%- if add_generation_prompt -%}
{{ role_start }}{{ assistant_role }}{{ role_end }}
{%- endif -%}"""

_compiled = None


def _template():
    """Compile the template at first use: jinja2 is imported lazily so the
    package imports where jinja2 is not installed."""
    global _compiled
    if _compiled is None:
        import jinja2

        env = jinja2.Environment(
            loader=jinja2.BaseLoader(), trim_blocks=False,
            lstrip_blocks=False, keep_trailing_newline=True,
        )
        _compiled = env.from_string(_TEMPLATE)
    return _compiled


def render_chat(
    messages: list[dict[str, Any]],
    control: ControlTokens,
    add_generation_prompt: bool = True,
    tools: Optional[list[dict]] = None,
) -> str:
    """Render a conversation to a prompt string.

    messages: [{"role": ..., "text": ...}]. Roles are remapped per family
    (assistant name, system folding when unsupported); tool definitions, when
    given, are injected into the system message as JSON (the reference
    pipes tools through the template the same way).
    """
    msgs = []
    system_text = None
    for m in messages:
        role = m["role"]
        text = m.get("text", "")
        if role == "assistant":
            role = control.assistant_role
        elif role == "tool":
            role = control.tool_role
        elif role == "system" and not control.supports_system:
            system_text = text
            continue
        msgs.append({"role": role, "text": text})
    if system_text is not None:
        # fold unsupported system message into the first user turn (gemma)
        for m in msgs:
            if m["role"] == "user":
                m["text"] = f"{system_text}\n\n{m['text']}"
                break
        else:
            msgs.insert(0, {"role": "user", "text": system_text})
    if tools:
        import json

        tool_desc = (
            "You have access to the following tools. To call a tool, "
            "respond with a JSON object {\"name\": ..., \"arguments\": ...}.\n"
            + "\n".join(json.dumps(t, ensure_ascii=False) for t in tools)
        )
        for m in msgs:
            if m["role"] == "system":
                m["text"] = f"{m['text']}\n\n{tool_desc}"
                break
        else:
            msgs.insert(0, {"role": "system" if control.supports_system else "user",
                            "text": tool_desc})
    turn_sep = "\n" if control.family in ("chatml", "gemma") else ""
    return _template().render(
        bos="",  # BOS is added as a token by the tokenizer, not as text
        messages=msgs,
        role_start=control.role_start,
        role_end=control.role_end,
        end_of_turn=control.end_of_turn,
        assistant_role=control.assistant_role,
        add_generation_prompt=add_generation_prompt,
        turn_sep=turn_sep,
    )
