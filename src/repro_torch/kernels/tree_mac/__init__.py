"""Tree MAC kernel: CUDA source csrc/tree_mac.cu, wrapper, plain version."""
