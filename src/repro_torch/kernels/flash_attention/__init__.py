"""GQA flash attention, forward (CUDA kernel in ``csrc/flash_attention.cu``)."""
