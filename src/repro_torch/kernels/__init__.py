"""Kernels of the port: CUDA C++ sources (``csrc/``), their ctypes
wrappers, the plain PyTorch versions (``ref``) and the device dispatch
(``ops``)."""
