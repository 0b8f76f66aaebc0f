"""The RG-LRU linear recurrence (CUDA kernel in ``csrc/rglru_scan.cu``)."""
