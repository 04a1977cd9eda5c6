"""PyTorch / CUDA port of the ``repro`` model-serving stack.

The JAX package ``repro`` is the reference; this package re-implements
its Level-B serving path (config -> model -> kernels -> ServingEngine)
in PyTorch for one NVIDIA H100, with the Pallas kernels replaced by
hand-written CUDA C++ kernels for ``sm_90a``.  It imports neither JAX
nor anything of ``repro``.
"""
