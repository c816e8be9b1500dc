"""Device-mesh construction and field sharding rules.

Fields and their layouts:

* cell fields       ``(..., nx, ny)``  -> ``P(..., 'X', 'Y')``
* node (CG) fields  ``(nx+1, ny+1)``   -> ``P('X', 'Y')`` (GSPMD pads the
  ragged last block; halo reads become collective-permutes)
* quad-point velocity ``(NQ, nx, ny)`` / edge fields -> sharded on the two
  spatial dims.

The step functions themselves are ordinary jitted functions: sharded inputs
make XLA partition the whole program (SPMD), inserting the halo exchanges.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def pick_mesh_shape(n_devices: int, nx: int, ny: int) -> Tuple[int, int]:
    """Grid-aware device-mesh factorization (px, py) for an (nx, ny) grid.

    Every device of one host reaches every other at the same rate, so
    the cost of a factorization is the halo it exchanges: take the
    factorization whose local block ``(nx/px, ny/py)`` divides the grid
    with the smallest perimeter. Ties split the leading axis X first,
    whose halo strips are contiguous rows of the row-major planes. Falls
    back to the squarest factorization when no factorization divides the
    grid (GSPMD pads uneven shards).
    """
    best = None
    best_key = None
    for px in range(1, n_devices + 1):
        if n_devices % px:
            continue
        py = n_devices // px
        if nx % px or ny % py:
            continue
        key = (nx // px + ny // py, -px)
        if best_key is None or key < best_key:
            best, best_key = (px, py), key
    if best is not None:
        return best
    px = int(np.floor(np.sqrt(n_devices)))
    while n_devices % px:
        px -= 1
    return (px, n_devices // px)


def make_spatial_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
    grid_shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """Create a 2-D ('X', 'Y') device mesh.

    Default shape: as square as the device count allows (e.g. 8 -> 4x2).
    With ``grid_shape`` (the global (nx, ny) element grid) the
    factorization is chosen by :func:`pick_mesh_shape`'s halo-perimeter
    rule instead; an explicit ``shape`` always wins.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None and grid_shape is not None:
        shape = pick_mesh_shape(n, *grid_shape)
    if shape is None:
        px = int(np.floor(np.sqrt(n)))
        while n % px:
            px -= 1
        shape = (px, n // px)
    # Auto axis types: GSPMD decides layouts/collectives and supports
    # unevenly-divisible dims (the CG node arrays are (nx+1, ny+1)).
    return jax.make_mesh(
        shape,
        ("X", "Y"),
        devices=devices,
        axis_types=(jax.sharding.AxisType.Auto, jax.sharding.AxisType.Auto),
    )


class SpatialPartition:
    """Sharding helpers bound to one device mesh."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh

    def spec_for_rank(self, ndim: int) -> P:
        """Spatial spec: last two dims over ('X', 'Y'), leading dims local."""
        if ndim < 2:
            return P()
        return P(*([None] * (ndim - 2) + ["X", "Y"]))

    def sharding_for(self, array) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for_rank(np.ndim(array)))

    def shard(self, tree):
        """device_put every array leaf with its spatial sharding."""
        return jax.tree.map(
            lambda leaf: jax.device_put(leaf, self.sharding_for(leaf)), tree
        )

    def constraint(self, tree):
        """Apply with_sharding_constraint inside jit (layout anchoring)."""
        return jax.tree.map(
            lambda leaf: jax.lax.with_sharding_constraint(
                leaf, self.sharding_for(leaf)
            ),
            tree,
        )
