"""embed_mfu.bulk: the encoder path's FLOPs (perfbench/yardstick/flops.py)
of the rows answered in the traced run's window, over its seconds, as a %
of the H100's float32 peak (67 TFLOP/s): the engine runs in full float32.
Padded rows count as no work."""

from perfbench.harness.readers import embed_mfu as read  # noqa: F401
