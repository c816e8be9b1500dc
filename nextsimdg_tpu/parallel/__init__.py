"""SPMD domain decomposition over device meshes.

The reference is single-process (SURVEY.md section 2.3); this package
supplies the scaling axis: the (x, y) element dims of every field
are sharded over a 2-D ``jax.sharding.Mesh``, and the jitted step functions
run under GSPMD, which turns the stencil shifts / pads of the DG transport
and mEVP operators into neighbor collective-permutes automatically.
Multi-host runs extend the same mesh across hosts via ``jax.distributed``.
"""

from .sharding import SpatialPartition, make_spatial_mesh, pick_mesh_shape

__all__ = ["SpatialPartition", "make_spatial_mesh", "pick_mesh_shape"]
