"""k2_roofline.ttft_p90: K2's share of its roofline in the traced slice, % (device trace)."""

from portbench.readers import k2_roofline as read  # noqa: F401
