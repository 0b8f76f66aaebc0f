"""Batched row gather (CUDA kernels in ``csrc/gather_rows.cu``)."""
