"""Meshes (port of ``repro/launch/mesh.py``).

The reference lays its pipeline over a JAX device mesh; on a host it forces
N CPU devices (``--xla_force_host_platform_device_count``).  The port has
one card and NCCL puts no two ranks on one GPU, so its mesh is shape only:
``.shape`` maps axis names to sizes, the way :func:`repro_torch.core.pipeline.geometry`
reads it, and one process emulates every position of the mesh on one
device (the replica columns and data replicas run one after another).

The production meshes are shape only too: single-pod (16, 16) over
("data", "model") = 256 chips, multi-pod (2, 16, 16) over ("pod", "data",
"model") = 512 chips, the "pod" axis carrying only the gradient all-reduce
and the batch split.  The step builders (:mod:`repro_torch.launch.steps`)
lay their sharding rules over them, and the dry-run
(:mod:`repro_torch.launch.dryrun`) accounts each cell on them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """Axis names and sizes of an emulated device mesh."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return int(math.prod(self.sizes))


def compat_make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> HostMesh:
    """The reference's ``jax.make_mesh`` shim: here a shape-only mesh of any
    size (no device is looked up)."""
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    return HostMesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes)


def make_host_mesh(shape: Tuple[int, ...] = (1, 2),
                   axes: Tuple[str, ...] = ("data", "model")) -> HostMesh:
    """An emulated mesh; by default (1, 2) over ("data", "model"): no data
    parallelism and two pipeline positions, the paper's host + phone pair."""
    return compat_make_mesh(shape, axes)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def dp_degree(mesh) -> int:
    return int(math.prod(mesh.shape[a] for a in data_axes(mesh)))
