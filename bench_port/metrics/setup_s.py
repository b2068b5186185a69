"""From the process's start to the first timed cycle: imports, the CUDA
context, the kernels' library (built on a checkout's first run), the
controller, its graph's capture and the warm-up episode."""


def read(run):
    return run.setup_s
