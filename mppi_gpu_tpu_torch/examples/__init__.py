"""Example programs of the port (counterparts of the repo's ``examples/``),
run as ``python -m mppi_gpu_tpu_torch.examples.<name>``."""
