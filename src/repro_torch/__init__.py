"""repro_torch — the PyTorch/CUDA port of the triangle-counting system.

A package beside the JAX reference ``repro``, with mirrored module paths
and public names.  It imports torch and numpy, never jax and nothing of
``repro``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the intersection kernels are hand-written CUDA C++
(:mod:`repro_torch.kernels.triangle_count`), built at first use.
"""
