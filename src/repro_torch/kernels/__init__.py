"""Hand-written Hopper kernels of the port, one directory per kernel.

Each kernel directory holds:
    ops.py  the wrapper: checks, device dispatch, launch count
    ref.py  the plain torch version (bit-exact; the CPU path and the
            yardstick the kernel is held against on the card)
and its CUDA source is ``csrc/<name>.cu`` (built by ``build.py``).

A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  ``<wrapper>.launches`` counts launches.
The CTR and MAC wrappers also take meta tensors (the dry run): they return
empty results and count, in ``<wrapper>.meta_launches``, the launches the
card would make.

``wkv6_scan`` and ``ssd_scan`` (RWKV-6's and Mamba-2's recurrences, forward
and backward) replace no Pallas kernel: the reference runs them as a
device-side ``jax.lax.scan``.  Their wrappers are ``torch.library`` custom
ops with autograd, a meta path and a FLOP formula, so the dry run counts
them whole.
"""
