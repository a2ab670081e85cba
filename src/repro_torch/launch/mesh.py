"""Production mesh shapes, without devices: the port's counterpart of
``repro/launch/mesh.py``.

The reference builds ``jax.sharding.Mesh``es over (faked) devices for its
dry run.  The port's dry run places nothing on a mesh: it traces each
cell once on the ``meta`` device and divides by the mesh.  So a mesh here
is only its axes and their sizes.  Single pod: 16×16 = 256 chips
(``data`` × ``model``); multi-pod: 2×16×16 = 512 chips with the leading
``pod`` axis as the cross-pod data-parallel dimension.  Sharded
retrieval takes ``partitions: int`` instead of the reference's
``retrieval_mesh``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh (the reference's ``mesh.devices.size``)."""
        return math.prod(self.sizes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))
