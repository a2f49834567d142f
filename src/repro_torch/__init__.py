"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

A second package beside the JAX reference: same layout and names, eager
PyTorch inside, and every Pallas TPU kernel on a ported path replaced by a
hand-written CUDA kernel (``csrc/``).  It imports nothing of ``jax`` or of
``repro``; ``core`` and ``obs`` are the port's own copies.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device=None`` means ``"cuda"`` and raises when no card is present).  On
the CPU each kernel wrapper runs its plain PyTorch version.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
