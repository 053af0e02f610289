"""Causal GQA attention kernels: CUDA source csrc/flash_attention.cu,
wrapper, plain version."""
