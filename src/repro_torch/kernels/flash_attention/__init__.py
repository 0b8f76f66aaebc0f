"""GQA flash attention, forward and backward (CUDA kernels in
``csrc/flash_attention.cu``)."""
