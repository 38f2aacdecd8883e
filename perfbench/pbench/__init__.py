"""The benchmark's own library: traffic, the open loop, the timing
clients, the trace reader, the yardstick's arithmetic (kernel costs, model
FLOPs, the H100's peaks) and the comparison that decides ``correct``.

It drives ``repro_torch`` (the PyTorch and CUDA port) only; nothing here
imports ``jax``, ``repro`` or ``benchmarks``."""
