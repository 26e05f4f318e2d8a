"""device_idle_share.interactive: % of the traced sub-window (host clock)
in which no kernel or copy ran on the card."""

from perfbench.harness.readers import idle_share as read  # noqa: F401
