"""Seconds of the set-up inside the port's top-level spans, recorded from
before the driver is built until its warm-up returns: the libraries' load
(and build), the graphs' captures, the warm-up's episodes or solves.
``setup_s`` less this is the interpreter, the imports, the CUDA context and
what the benchmark does around the port."""

from bench_port import spans


def read(run):
    s = getattr(run, "setup_spans", None)
    return spans.top_level_s(s) if s else None
