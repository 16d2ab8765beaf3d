"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; every module here keeps the
name and public names of its JAX counterpart.  This package imports
``torch`` and ``numpy`` only.  Entry points run on the card unless the
caller asks for the CPU (``device="cpu"``); see ``repro_torch.device``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
