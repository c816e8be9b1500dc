"""Every multi-device path against the single-device step.

GSPMD (the global step with sharded inputs), shard_map with per-subcycle
width-1 halos, and shard_map with the blocked ghost-zone exchange, over
the configurations the sharded runs must carry: the full longitude ring
on a sphere, a graded mesh, the CG2/dG1 solver, a coastline and the TVB
slope limiter. f64 on the 8-device CPU mesh.

Tolerance: the same math in different compilation contexts; XLA's FMA
fusion can differ between the global and the partitioned programs and
the mEVP stress feedback amplifies a 1-ulp seed (see
tests/test_shardmap.py), so rtol 1e-8 over one coupled step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nextsimdg_tpu.coupled import CoupledModel
from nextsimdg_tpu.dynamics import RectMesh
from nextsimdg_tpu.dynamics.landmask import synthetic_coastline
from nextsimdg_tpu.dynamics.mesh import SphericalMesh
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
from nextsimdg_tpu.modules import ModuleRegistry
from nextsimdg_tpu.parallel import SpatialPartition, make_spatial_mesh
from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model
from nextsimdg_tpu.state import Forcing

N = 16


def _config(name):
    """(mesh, CoupledModel kwargs, high order?) of one configuration."""
    uniform = RectMesh(nx=N, ny=N, dx=32e3, dy=32e3)
    if name == "ring":
        mesh = SphericalMesh(
            nx=N, ny=N, lon0=0.0, lon1=360.0, lat0=55.0, lat1=75.0,
            periodic_x=True,
        )
        return mesh, {}, False
    if name == "graded":
        dx = 30e3 * (1.0 + 0.05 * np.arange(N))
        dy = 32e3 * (1.0 + 0.03 * np.arange(N)[::-1])
        return RectMesh(nx=N, ny=N, dx=dx, dy=dy), {}, False
    if name == "cg2dg1":
        return uniform, {}, True
    if name == "land":
        return uniform, {"ocean_mask": synthetic_coastline(N)}, False
    if name == "tvb":
        return uniform, {"tvb_m": 50.0}, False
    raise ValueError(name)


@pytest.mark.parametrize("path", ["gspmd", "shardmap", "blocked"])
@pytest.mark.parametrize("config", ["ring", "graded", "cg2dg1", "land", "tvb"])
def test_path_matches_single_device(config, path):
    mesh, kwargs, high_order = _config(config)
    if high_order:
        ModuleRegistry.get_loader().set_implementation(
            "Nextsim::IDynamics", "Nextsim::MEVPHighOrder"
        )
    model = CoupledModel(mesh, degree=1, n_subcycles=10, **kwargs)
    dtype = jnp.float64
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=dtype)
    full = lambda v: jnp.full((N, N), v, dtype)
    pf = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    gx = jnp.asarray(np.linspace(6.0, 10.0, N)[:, None] * np.ones((1, N)))
    df = DynamicsForcing(
        u_atm=gx, v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    expected = model.step(state, pf, df, dt=600.0)

    device_mesh = make_spatial_mesh((4, 2))
    if path == "gspmd":
        part = SpatialPartition(device_mesh)
        got = model.step(part.shard(state), part.shard(pf), part.shard(df), dt=600.0)
        assert len(jax.tree.leaves(got)[0].sharding.device_set) == 8
    else:
        backend = {"mevp_backend": "blocked", "mevp_block_halo": 3} if path == "blocked" else {}
        sharded_model, step = build_sharded_coupled_model(
            mesh, device_mesh, degree=1, n_subcycles=10, **kwargs, **backend
        )
        assert sharded_model.mevp._kernel_choice() == (
            "blocked" if path == "blocked" else "xla"
        )
        got = step(state, pf, df, 600.0)
    for a, b in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-8, atol=1e-11,
            err_msg=f"{config} {path}",
        )
    # The step did something: velocities moved off zero.
    assert float(jnp.max(jnp.abs(jax.tree.leaves(got.velocity)[0]))) > 1e-6
