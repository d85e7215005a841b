"""Mesh shapes of the dry-run (counterpart of ``repro.launch.mesh``).

The port runs on one card and places no tensor on a mesh: a ``MeshShape``
is the device-free pair of axis names and sizes that the sharding rules
read (``axis_names`` and ``shape``, as the reference's ``Mesh`` offers
them).  The reference's production meshes are TPU v5e pods; here they are
shapes only, for per-device argument bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class MeshShape:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes} differ")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's 16x16 (data, model) pod, or 2x16x16 (pod, data,
    model) across two pods, as shapes."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_card_mesh() -> MeshShape:
    """The one H100: a 1x1 (data, model) mesh."""
    return MeshShape(("data", "model"), (1, 1))


MESHES = {"card_1x1": make_card_mesh,
          "pod_16x16": lambda: make_production_mesh(multi_pod=False),
          "multipod_2x16x16": lambda: make_production_mesh(multi_pod=True)}


def chips_in(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n


__all__ = ["MeshShape", "make_production_mesh", "make_card_mesh", "MESHES",
           "chips_in"]
