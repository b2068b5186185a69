"""mppi_gpu_tpu_torch — the PyTorch/CUDA port of ``mppi_gpu_tpu``.

The same MPPI controller (K noisy rollouts over a horizon T, softmin
weighting, weighted update, clamp, shift) written in PyTorch, with the hot
solve as hand-written CUDA kernels for NVIDIA Hopper (sm_90a). The module
names mirror the JAX package so each counterpart is easy to find; the JAX
package stays the reference the port is tested against.

Importing the package builds nothing and imports no kernel: the CUDA library
is compiled on the first launch on a CUDA device (``ops/_build.py``), and so
is the library of a fused family registered from user code
(:func:`register_family`, ``ops/families.py``).
"""

from mppi_gpu_tpu_torch.config import MPPIConfig, load_config

__version__ = "0.1.0"

__all__ = ["MPPIConfig", "load_config", "register_family", "unregister_family"]


def __getattr__(name: str):
    # register_family and unregister_family come from ops/families, which
    # imports torch: loaded on first use, so importing the package stays light
    if name in ("register_family", "unregister_family"):
        from mppi_gpu_tpu_torch.ops import families

        return getattr(families, name)
    raise AttributeError(f"module 'mppi_gpu_tpu_torch' has no attribute '{name}'")
