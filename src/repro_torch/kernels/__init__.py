"""Hand-written Hopper kernels of the port and their plain versions.

`ops` is the public surface (device dispatch + launch counters), `ref`
the plain PyTorch versions, ``csrc/`` the CUDA sources that `_build`
compiles at the first CUDA call.
"""
