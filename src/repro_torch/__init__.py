"""repro_torch — the PyTorch/CUDA port of the sealed-offload system.

A second package beside the JAX reference ``repro``: the same sealing,
verification and paged serving, with the Pallas kernels rewritten as CUDA
kernels for Hopper (``csrc/``).  It imports torch and never jax, and
nothing of ``repro``.  Entry points run on the card unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain torch
version.
"""
