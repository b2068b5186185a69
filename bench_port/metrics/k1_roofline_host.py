"""``k1_roofline`` in the host loop (metric ``k1_roofline.host``), which
reports ``step_ms``."""

from bench_port.metrics.k1_roofline import read  # noqa: F401
