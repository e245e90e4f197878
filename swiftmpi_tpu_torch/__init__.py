"""swiftmpi_tpu_torch — the PyTorch/CUDA port of swiftmpi_tpu.

A second package beside the JAX one, module for module: ``utils``,
``ops``, ``parameter``, ``transfer``, ``data``, ``models``, ``io`` and
``apps`` keep the JAX package's layout and names, and ``kernels`` holds
the hand-written CUDA C++ kernels that stand in for its Pallas kernels.
The port imports ``torch`` and numpy, never ``jax`` and nothing of
``swiftmpi_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`swiftmpi_tpu_torch.device.resolve_device`).
On the CPU every kernel wrapper runs its plain PyTorch version.
"""

from swiftmpi_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
