"""output_tok_s: output tokens streamed in the window over its seconds (host clock)."""

from portbench.readers import output_tok_s as read  # noqa: F401
