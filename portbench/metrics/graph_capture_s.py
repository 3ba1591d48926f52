"""graph_capture_s: StepGraphs' capture seconds in set-up (program counter)."""

from portbench.readers import graph_capture_s as read  # noqa: F401
