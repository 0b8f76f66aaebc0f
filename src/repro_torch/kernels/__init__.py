"""Hand-written Hopper kernels of the Spatter main path and their wrappers.

``gather_rows`` and ``scatter_rows`` each hold a wrapper (``ops``), the plain
PyTorch version of the same function (``ref``), and their CUDA source under
``src/repro_torch/csrc``.  A wrapper given CUDA tensors launches its kernel
(or raises); given CPU tensors it runs the plain version.  Nothing is built
at import time: ``_build`` compiles the sources with ``nvcc`` at first use.
"""
from ._build import KERNELS, launches, reset_launches

__all__ = ["KERNELS", "launches", "reset_launches"]
