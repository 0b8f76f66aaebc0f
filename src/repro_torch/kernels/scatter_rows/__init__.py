"""Batched row scatter (CUDA kernels in ``csrc/scatter_rows.cu``)."""
