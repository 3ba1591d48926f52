"""mfu_pct.tok: model FLOPs over device-busy time at the bf16 peak in the traced slice, % (device trace)."""

from portbench.readers import mfu_pct as read  # noqa: F401
