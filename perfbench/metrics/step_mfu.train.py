"""step_mfu.train: the frozen FLOP count of one train step
(perfbench/yardstick/flops.py, 3x the forward's convolutions and linears)
times the steps of the traced run's window, over its seconds, as a % of the
H100's dense bf16 peak (989 TFLOP/s)."""

from perfbench.harness.readers import train_mfu as read  # noqa: F401
