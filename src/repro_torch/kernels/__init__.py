"""Hand-written Hopper kernels of the port and their wrappers.

Each wrapper checks its operands, takes its plain version (``ref``) for CPU
tensors and launches its CUDA kernel (``csrc/``, built at first use by
``_build``) for CUDA tensors, counting launches in ``<wrapper>.launches``.
"""
