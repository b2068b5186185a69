"""One reader per metric, found by the metric's name in ``BENCHMARK.json``:
``bench_port/metrics/<name>.py`` (a dot in the name an underscore) holds
``read(run)``, which takes the run
(``bench_port.run.Run``: its set-up time, its window, its trace and the
cycle's counted work) and returns the metric's value, or None where it
finds nothing to read; the run then leaves the metric out of its line.
The name ``<kernel>_roofline`` is a kernel's share of its least time."""
