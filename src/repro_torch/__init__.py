"""PyTorch/CUDA port of the ThunderServe reproduction for one NVIDIA H100.

A second package beside ``repro`` (the JAX reference, which it never
imports). Module names follow the reference so each module's counterpart
is easy to find. Kernels are hand-written CUDA C++ for ``sm_90a`` under
``kernels/csrc``; on a CPU tensor every kernel wrapper dispatches to its
plain PyTorch version (``kernels/ref.py``), on a CUDA tensor it launches
the kernel or raises.
"""
