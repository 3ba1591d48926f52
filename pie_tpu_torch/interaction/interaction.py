"""Interaction: a single conversational turn.

Reference parity: interaction/interaction.py:12-127 (role, content list,
metadata passthrough, to_dict for chat templating).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

from pie_tpu_torch.interaction.content import Content, ContentType


class InteractionRole(str, enum.Enum):
    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"
    TOOL = "tool"


class InteractionType(str, enum.Enum):
    MESSAGE = "message"
    TOOL_RESULT = "tool_result"


@dataclasses.dataclass
class Interaction:
    role: InteractionRole
    content: list[Content] = dataclasses.field(default_factory=list)
    type: InteractionType = InteractionType.MESSAGE
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def simple(cls, role: InteractionRole | str, text: str) -> "Interaction":
        return cls(
            role=InteractionRole(role), content=[Content.text_content(text)]
        )

    @property
    def text(self) -> str:
        return "".join(
            c.text for c in self.content
            if c.type in (ContentType.TEXT, ContentType.REASONING) and c.text
        )

    @property
    def tool_calls(self) -> list[dict[str, Any]]:
        return [
            c.tool_call for c in self.content
            if c.type == ContentType.TOOL_CALL and c.tool_call
        ]

    @property
    def images(self) -> list[str]:
        return [
            c.image_url for c in self.content
            if c.type == ContentType.IMAGE and c.image_url
        ]

    def __getattr__(self, name: str) -> Any:
        # metadata passthrough (reference interaction/interaction.py
        # __getattribute__ metadata surface)
        meta = object.__getattribute__(self, "metadata")
        if name in meta:
            return meta[name]
        raise AttributeError(name)

    def to_dict(self) -> dict[str, Any]:
        return {
            "role": self.role.value,
            "content": [c.to_dict() for c in self.content],
            "text": self.text,
            **self.metadata,
        }
