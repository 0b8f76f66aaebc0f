"""Mamba-1 selective scan (CUDA kernel in ``csrc/selective_scan.cu``)."""
