"""setup_s: process start to the window's opening, s (host clock)."""

from portbench.readers import setup_s as read  # noqa: F401
