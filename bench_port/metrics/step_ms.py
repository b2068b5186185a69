"""The host loop's wall time over the steps completed in the window, the
plant's cycle included: a step is one control cycle of the robot."""

from bench_port.metrics.cycle_ms import read  # noqa: F401
