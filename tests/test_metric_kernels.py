"""Spherical metric planes together with a coastline mask."""

import jax.numpy as jnp
import numpy as np

from nextsimdg_tpu.dynamics.mesh import SphericalMesh
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing


def _coupled_setup(mesh, ocean_mask=None):
    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.state import Forcing

    model = CoupledModel(
        mesh, degree=1, n_subcycles=10, ocean_mask=ocean_mask,
    )
    state = model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=jnp.float64
    )
    n = mesh.nx
    full = lambda v: jnp.full((n, n), v, jnp.float64)
    pf = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    df = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    return model, state, pf, df


def _synthetic_coast(n):
    """A coastline mask: land in the lower-left quarter + an island."""
    mask = np.ones((n, n))
    mask[: n // 4, : n // 4] = 0.0
    mask[n // 2 : n // 2 + 2, n // 2 : n // 2 + 2] = 0.0
    return mask


def test_spherical_landmask_conservation():
    """Ice volume is conserved under pure transport on a spherical mesh
    with a coastline (impermeable faces x exact zone areas)."""
    mesh = SphericalMesh(16, 16, lon0=0.0, lon1=12.0, lat0=68.0, lat1=78.0)
    coast = _synthetic_coast(16)
    model, state, pf, df = _coupled_setup(mesh, ocean_mask=coast)
    mass0 = float(model.transport.total_mass(state.hice))
    out = state
    for _ in range(3):
        out = model.step(out, pf, df, dt=600.0, do_thermo=False)
    mass1 = float(model.transport.total_mass(out.hice))
    np.testing.assert_allclose(mass1, mass0, rtol=1e-10)
    assert np.all(np.isfinite(np.asarray(out.hice)))
