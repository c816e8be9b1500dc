"""Explicit shard_map driver for the coupled model.

The default multi-chip path jits the global step with sharded inputs and
lets GSPMD partition it. This module provides the *explicit* SPMD form:
the model is built on the per-device LOCAL block and run under
``jax.shard_map``; every neighbor access halo-exchanges block edges with
``lax.ppermute`` over the ('X','Y') device mesh (see dynamics.stencil).
This is the controlled-communication path — the collectives are exactly the
width-1 halo permutes the algorithm needs, nothing inferred.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..coupled import CoupledModel
from ..dynamics.mesh import RectMesh


def _spatial_spec(ndim: int) -> P:
    if ndim < 2:
        return P()
    return P(*([None] * (ndim - 2) + ["X", "Y"]))


def _specs_like(tree):
    return jax.tree.map(lambda leaf: _spatial_spec(np.ndim(leaf)), tree)


def build_sharded_coupled_model(
    global_mesh: RectMesh,
    device_mesh: Mesh,
    degree: int = 1,
    **model_kwargs,
):
    """Build a CoupledModel on the local block + a sharded step function.

    Returns ``(model, sharded_step)`` where ``sharded_step(state, pf, df,
    dt, do_dynamics=True, do_thermo=True)`` expects GLOBAL arrays sharded
    over ``device_mesh`` (or unsharded; jit will move them) and runs the
    explicit shard_map program. ``model.initial_state()`` builds LOCAL
    blocks — use the global-shaped constructors below instead.
    """
    px, py = device_mesh.devices.shape
    if global_mesh.nx % px or global_mesh.ny % py:
        raise ValueError(
            f"grid {global_mesh.nx}x{global_mesh.ny} not divisible by "
            f"device mesh {px}x{py}"
        )
    if global_mesh.uniform:
        local_mesh = RectMesh(
            nx=global_mesh.nx // px,
            ny=global_mesh.ny // py,
            dx=global_mesh.dx,
            dy=global_mesh.dy,
            x0=global_mesh.x0,
            y0=global_mesh.y0,
            periodic_x=global_mesh.periodic_x,
            periodic_y=global_mesh.periodic_y,
        )
    else:
        # Graded/spherical global meshes: each device's block has ITS OWN
        # metric, which one shard_map trace cannot hold statically — the
        # LocalMeshView slices the global metric factors by device
        # coordinates at trace time, and the solvers route it through
        # their metric const planes (so the blocked exchange keeps
        # working; see dynamics.mesh.LocalMeshView).
        from ..dynamics.mesh import LocalMeshView

        local_mesh = LocalMeshView(global_mesh, px, py)
    model = CoupledModel(local_mesh, degree=degree, spmd=("X", "Y"), **model_kwargs)

    @partial(jax.jit, static_argnames=("dt", "do_dynamics", "do_thermo"))
    def sharded_step(state, phys_forcing, dyn_forcing, dt,
                     do_dynamics=True, do_thermo=True):
        fn = lambda s, p, d: model.step(s, p, d, dt, do_dynamics, do_thermo)
        return jax.shard_map(
            fn,
            mesh=device_mesh,
            in_specs=(_specs_like(state), _specs_like(phys_forcing), _specs_like(dyn_forcing)),
            out_specs=_specs_like(state),
            check_vma=False,
        )(state, phys_forcing, dyn_forcing)

    return model, sharded_step
