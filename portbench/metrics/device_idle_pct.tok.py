"""device_idle_pct.tok: share of the traced slice with no operation on the device, % (device trace)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
