"""Per-family control-token registry.

Reference parity: tokenizer/control_tokens/__init__.py:21-100 (ControlTokens
registry for llama/chatml/gemma selected by eos-token sniffing) — re-done as
dataclasses instead of JSON files; same capability, our own schema.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ControlTokens:
    family: str
    bos: str
    eos: str
    end_of_turn: str
    role_start: str  # format with role via role_header()
    role_end: str
    end_of_message: Optional[str] = None  # tool-call continuation marker
    assistant_role: str = "assistant"
    tool_role: str = "tool"
    supports_system: bool = True
    image_token: Optional[str] = None  # placeholder expanded by the engine

    def role_header(self, role: str) -> str:
        return f"{self.role_start}{role}{self.role_end}"

    @property
    def stop_token_strings(self) -> list[str]:
        out = [self.end_of_turn, self.eos]
        if self.end_of_message:
            out.append(self.end_of_message)
        return list(dict.fromkeys(out))

    @property
    def all_control_tokens(self) -> list[str]:
        toks = [self.bos, self.eos, self.end_of_turn]
        if self.end_of_message:
            toks.append(self.end_of_message)
        for t in (self.role_start, self.role_end):
            t = t.strip("\n")
            if t:
                toks.append(t)
        return list(dict.fromkeys(t for t in toks if t))


LLAMA3 = ControlTokens(
    family="llama3",
    bos="<|begin_of_text|>",
    eos="<|end_of_text|>",
    end_of_turn="<|eot_id|>",
    end_of_message="<|eom_id|>",
    role_start="<|start_header_id|>",
    role_end="<|end_header_id|>\n\n",
    tool_role="ipython",
)

CHATML = ControlTokens(
    family="chatml",
    bos="",
    eos="<|endoftext|>",
    end_of_turn="<|im_end|>",
    role_start="<|im_start|>",
    role_end="\n",
    image_token="<|image_pad|>",
)

GEMMA = ControlTokens(
    family="gemma",
    bos="<bos>",
    eos="<eos>",
    end_of_turn="<end_of_turn>",
    role_start="<start_of_turn>",
    role_end="\n",
    assistant_role="model",
    supports_system=False,
    image_token="<image_soft_token>",
)

_FAMILIES = {"llama3": LLAMA3, "chatml": CHATML, "gemma": GEMMA}

# eos-token sniffing (reference tokenizer/control_tokens/__init__.py:81-91)
_EOS_TO_FAMILY = {
    "<|end_of_text|>": "llama3",
    "<|eot_id|>": "llama3",
    "<|im_end|>": "chatml",
    "<|endoftext|>": "chatml",
    "<eos>": "gemma",
    "<end_of_turn>": "gemma",
}


def get_control_tokens(
    family: Optional[str] = None, eos_token: Optional[str] = None
) -> ControlTokens:
    if family:
        if family not in _FAMILIES:
            raise ValueError(
                f"unknown control-token family {family!r}; "
                f"known: {sorted(_FAMILIES)}"
            )
        return _FAMILIES[family]
    if eos_token and eos_token in _EOS_TO_FAMILY:
        return _FAMILIES[_EOS_TO_FAMILY[eos_token]]
    return LLAMA3
