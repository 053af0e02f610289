"""Sealed matmul: CUDA source csrc/sealed_matmul.cu, wrapper, plain
version."""
