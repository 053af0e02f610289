"""Mamba-2 SSD scan kernels: CUDA source csrc/ssd_scan.cu, wrapper, plain
version."""
