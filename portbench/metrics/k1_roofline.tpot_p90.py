"""k1_roofline.tpot_p90: K1's share of its roofline in the traced slice, % (device trace)."""

from portbench.readers import k1_roofline as read  # noqa: F401
