"""Content blocks carried by an Interaction.

Reference parity: interaction/content.py:9-49 (text / image / tool_call
factories).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class ContentType(str, enum.Enum):
    TEXT = "text"
    IMAGE = "image"
    TOOL_CALL = "tool_call"
    REASONING = "reasoning"


@dataclasses.dataclass
class Content:
    type: ContentType
    text: Optional[str] = None
    image_url: Optional[str] = None
    tool_call: Optional[dict[str, Any]] = None

    @classmethod
    def text_content(cls, text: str) -> "Content":
        return cls(type=ContentType.TEXT, text=text)

    @classmethod
    def image_content(cls, url: str) -> "Content":
        return cls(type=ContentType.IMAGE, image_url=url)

    @classmethod
    def tool_call_content(
        cls, name: str, arguments: Any, call_id: Optional[str] = None
    ) -> "Content":
        return cls(
            type=ContentType.TOOL_CALL,
            tool_call={"name": name, "arguments": arguments, "id": call_id},
        )

    @classmethod
    def reasoning_content(cls, text: str) -> "Content":
        return cls(type=ContentType.REASONING, text=text)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"type": self.type.value}
        if self.text is not None:
            d["text"] = self.text
        if self.image_url is not None:
            d["image_url"] = self.image_url
        if self.tool_call is not None:
            d["tool_call"] = self.tool_call
        return d
