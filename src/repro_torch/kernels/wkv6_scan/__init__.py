"""RWKV-6 WKV scan kernels: CUDA source csrc/wkv6_scan.cu, wrapper, plain
version."""
