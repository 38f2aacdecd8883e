"""Mesh builders (``repro.launch.mesh``) over ``torch.distributed``.

Functions, not module-level constants: importing this module touches no
process group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
built over the process group the caller initialized
(``torch.distributed.init_process_group`` with its address, world size
and rank: nothing here discovers a cluster). Its device type is ``cuda``
unless the caller asks for the CPU, as the entry points run.

The reference reads an axis's size as ``mesh.shape[name]``, a dict
lookup; a ``DeviceMesh``'s ``shape`` is a tuple, so :func:`shape_of`
gives the dict and :func:`axis_group` an axis's size, rank and
collectives (``distributed/comm.py``).

:func:`abstract_mesh` is a mesh with no process group, the dry-run's
(``launch/dryrun.py``; the counterpart of the reference's 512 forced
host devices): the same ``shape_of``/``data_axes``/``axis_group``
interface, this process rank 0 of every axis unless the caller names
another, and each axis's collectives counted, not run
(``comm.CountingGroup``).
"""
from __future__ import annotations

import math
import types
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.comm import CountingGroup, Group


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production meshes: (16, 16) ``data x model``, or
    (2, 16, 16) ``pod x data x model``. Raises unless the world has its
    256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise RuntimeError(
            f"the production mesh {shape} needs {math.prod(shape)} ranks; "
            f"the process group has {world}")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, *, device="cuda"):
    """A mesh of ``shape`` over the initialized process group, its axes
    named ``axes`` (row-major over the global ranks)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the process group first "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


class AbstractMesh:
    """A mesh of ``shape`` with axes ``axes`` and no process group (see
    :func:`abstract_mesh`)."""

    def __init__(self, shape, axes, ranks=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} for axes {axes}")
        self.mesh_dim_names = tuple(axes)
        self.mesh = types.SimpleNamespace(shape=tuple(int(n) for n in shape))
        self.ranks = dict(ranks or {})

    def get_local_rank(self, name: str) -> int:
        return self.ranks.get(name, 0)


def abstract_mesh(shape, axes, ranks=None) -> AbstractMesh:
    """A mesh of ``shape`` named ``axes`` that needs no process group:
    this process the rank ``ranks`` names on an axis (``{axis: index}``),
    else 0, its collectives counted on meta tensors."""
    return AbstractMesh(shape, axes, ranks)


def shape_of(mesh) -> Dict[str, int]:
    """``{axis name: size}``, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shape_of(mesh))


def model_axis(mesh) -> str:
    return "model"


def axis_group(mesh, name: str) -> Group:
    """The :class:`~repro_torch.distributed.comm.Group` of axis ``name``
    (its size, this rank's index on it, its collectives), built once a
    mesh and axis."""
    groups = mesh.__dict__.setdefault("_repro_groups", {})
    if name not in groups:
        groups[name] = CountingGroup(shape_of(mesh)[name], name,
                                     mesh.get_local_rank(name)) \
            if isinstance(mesh, AbstractMesh) else \
            Group(mesh.get_group(name), name)
    return groups[name]
