"""tokens_per_step.tok: output tokens over the paged engine's device steps in the window (program counter)."""

from portbench.readers import tokens_per_step as read  # noqa: F401
