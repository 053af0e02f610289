"""Hand-written Hopper kernels of the port, one directory per kernel.

Each kernel directory holds:
    ops.py  the wrapper: checks, device dispatch, launch count
    ref.py  the plain torch version (bit-exact; the CPU path and the
            yardstick the kernel is held against on the card)
and its CUDA source is ``csrc/<name>.cu`` (built by ``build.py``).

A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  ``<wrapper>.launches`` counts launches.
"""
