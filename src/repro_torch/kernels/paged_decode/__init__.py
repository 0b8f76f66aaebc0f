"""GQA decode attention over a paged KV pool (CUDA kernel in
``csrc/paged_decode.cu``)."""
