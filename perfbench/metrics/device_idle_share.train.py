"""device_idle_share.train: % of the profiled train epoch's span (CUDA events
on the fit's stream) in which no kernel or copy ran on the card."""

from perfbench.harness.readers import idle_share as read  # noqa: F401
