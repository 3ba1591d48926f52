"""k3_roofline.tpot_p90: K3's share of its roofline in the traced slice, % (device trace)."""

from portbench.readers import k3_roofline as read  # noqa: F401
