"""CTR cipher kernel: CUDA source csrc/ctr_cipher.cu, wrapper, plain version."""
