"""``cycle_mfu`` of the host loop's step: the solve's counted work over the
traced time per step."""

from bench_port.metrics.cycle_mfu import read  # noqa: F401
