"""Tensor, expert and pipeline parallelism over ``torch.distributed``
(the port of ``repro.distributed``): explicit SPMD, every rank holding
its own shard and running the same program, the collectives placed by
the layers."""
