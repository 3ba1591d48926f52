"""device_idle_pct.tpot_p90: share of the traced slice with no operation on the device, % (device trace)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
