"""Sealed flash-decode attention: CUDA source csrc/sealed_attention.cu,
wrapper, plain version."""
