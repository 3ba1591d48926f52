"""Interaction data model (reference interaction/__init__.py:4-26)."""

from pie_tpu_torch.interaction.content import Content, ContentType
from pie_tpu_torch.interaction.interaction import (
    Interaction,
    InteractionRole,
    InteractionType,
)
