"""``idle_pct`` in the host loop (metric ``idle_pct.host``), under the tracer,
which records every host operation of the loop."""

from bench_port.metrics.idle_pct import read  # noqa: F401
