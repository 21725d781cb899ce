"""Device meshes for the sharded tiers.

The counterpart of ``repro.launch.mesh``.  One process drives the whole
mesh (as one JAX process drives every device through ``shard_map``): a
:class:`Mesh` is a grid of ``torch.device`` entries with named axes, and
the sharded tiers keep one tensor per mesh position on that position's
device.  A device may appear at several positions, as XLA's virtual host
devices do: a 2 x 2 mesh of ``cuda:0`` runs the whole schedule on one card,
and ``["cpu"] * 8`` is the CPU mesh the tests use.  With distinct devices
(``cuda:0`` .. ``cuda:k``) the same code runs across cards.

A mesh never picks a device of its own accord: ``devices=None`` takes
every visible CUDA device and raises without CUDA; the CPU must be named.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_production_mesh"]


class Mesh:
    """Named axes over a grid of devices.

    ``shape`` maps each axis name to its size (in axis order, as JAX's
    ``Mesh.shape``), ``axis_names`` is the tuple of names, ``size`` the
    number of positions and ``devices`` the object array of
    ``torch.device`` with one entry per position.  Positions are numbered
    in row-major order over the axes; :meth:`coords` gives a position's
    coordinate on each axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)
        self.device_list = [torch.device(d) for d in devices.reshape(-1)]
        # the schedule reads these on every iteration: computed once
        self._coords = tuple(
            dict(zip(axis_names, (int(i) for i in np.unravel_index(
                p, devices.shape)))) for p in range(self.size))
        self._hash = hash((axis_names, devices.shape,
                           tuple(str(d) for d in self.device_list)))

    def coords(self, pos: int) -> dict[str, int]:
        """The coordinate of position ``pos`` on every axis (read-only)."""
        return self._coords[pos]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.shape == other.shape
                and self.device_list == other.device_list)

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes}; devices {[str(d) for d in self.device_list]})"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.  ``devices`` lists one
    device per position in row-major order (repeats allowed); ``None``
    takes every visible CUDA device, whose count must equal the mesh
    size."""
    shape = tuple(int(s) for s in shape)
    if devices is None:
        resolve_device("cuda")          # raises without CUDA
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        resolve_device(d)
    if len(devices) != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                         f"got {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16 x 16 = 256 positions per pod; 2 x 16 x 16 = 512 multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(devices=None) -> Mesh:
    """The given devices (by default every visible CUDA device) as a
    (data, model) mesh with model = 1."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return make_mesh((len(devices), 1), ("data", "model"), devices)
