"""The plain reference the benchmark holds the port's outputs to: NumPy and
PyTorch only, written from the controller's and the worlds' definitions. It
imports nothing of the port and takes nothing the port has made."""
