"""The f32 coupled step against the f64 step of the same XLA code.

The accelerator runs the model in f32; the f64 run of the same program is
its plain reference. Over the mesh geometries, boundary conditions and
momentum options of both mEVP discretizations, two coupled steps in f32
must stay within ``TOL`` of f64 on every prognostic leaf, measured as the
leaf's largest difference over its largest magnitude.

``TOL``: f32 rounds at 6e-8; the mEVP subcycles amplify it through the
strain rates (differences of neighbouring velocities) and the viscosities
1/(Delta + Delta_min) of the nearly rigid pack, so the stresses carry the
largest relative differences — about 1e-5 at these sizes. 1e-3 bounds
that with margin while still catching an f64 constant or a dtype
promotion that changes the result at the 1e-2 level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nextsimdg_tpu.coupled import CoupledModel
from nextsimdg_tpu.dynamics import MEVPParams, RectMesh
from nextsimdg_tpu.dynamics.landmask import synthetic_coastline
from nextsimdg_tpu.dynamics.mesh import SphericalMesh
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
from nextsimdg_tpu.modules import ModuleRegistry
from nextsimdg_tpu.state import Forcing

TOL = 1e-3
N = 16


def _mesh(kind):
    if kind == "uniform":
        return RectMesh(nx=N, ny=N, dx=8e3, dy=8e3)
    if kind == "periodic":
        return RectMesh(nx=N, ny=N, dx=8e3, dy=8e3, periodic_x=True, periodic_y=True)
    if kind == "graded":
        dx = 6e3 * (1.0 + 0.05 * np.arange(N))
        dy = 7e3 * (1.0 + 0.03 * np.arange(N)[::-1])
        return RectMesh(nx=N, ny=N, dx=dx, dy=dy)
    if kind == "spherical":
        return SphericalMesh(N, N, lon0=-10.0, lon1=10.0, lat0=70.0, lat1=78.0)
    if kind == "ring":
        return SphericalMesh(
            N, N, lon0=0.0, lon1=360.0, lat0=60.0, lat1=75.0, periodic_x=True
        )
    raise ValueError(kind)


CASES = {
    # id: (high_order, mesh, land mask, MEVPParams kwargs, Winton)
    "cg1-uniform": (False, "uniform", False, {}, False),
    "cg1-periodic": (False, "periodic", False, {}, False),
    "cg1-graded": (False, "graded", False, {}, False),
    "cg1-spherical": (False, "spherical", False, {}, False),
    "cg1-ring": (False, "ring", False, {}, False),
    "cg1-uniform-land": (False, "uniform", True, {}, False),
    "cg1-spherical-land": (False, "spherical", True, {}, True),
    "cg1-a-weighted": (False, "uniform", False, {"a_weighted_stress": True}, False),
    "cg1-adaptive": (False, "uniform", False, {"adaptive_alpha": True}, False),
    "cg1-graded-adaptive": (False, "graded", False, {"adaptive_alpha": True}, False),
    "cg2dg1-uniform": (True, "uniform", False, {}, False),
    "cg2dg1-periodic": (True, "periodic", False, {}, False),
    "cg2dg1-graded": (True, "graded", False, {}, False),
    "cg2dg1-ring": (True, "ring", False, {}, False),
    "cg2dg1-spherical-land": (True, "spherical", True, {}, True),
    "cg2dg1-a-weighted": (True, "uniform", False, {"a_weighted_stress": True}, False),
}


def _run(case, dtype, steps=2):
    high_order, kind, land, params, winton = CASES[case]
    loader = ModuleRegistry.get_loader()
    if high_order:
        loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    if winton:
        loader.set_implementation("Nextsim::IThermodynamics", "Nextsim::ThermoWinton")
    ocean = synthetic_coastline(N) if land else None
    model = CoupledModel(
        _mesh(kind), degree=1, n_subcycles=10, ocean_mask=ocean,
        mevp_params=MEVPParams(**params),
    )
    state = model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, nlayers=3 if winton else 1,
        tice0=-5.0, dtype=dtype,
    )
    # Non-uniform ice so the rheology sees gradients.
    ii = np.arange(N)[:, None] / N
    jj = np.arange(N)[None, :] / N
    hice = jnp.asarray(1.0 + 0.5 * np.sin(2 * np.pi * ii) * np.cos(np.pi * jj), dtype)
    mask = 1.0 if ocean is None else jnp.asarray(ocean, dtype)
    state = dataclasses.replace(
        state, hice=state.hice.at[0].set(hice * mask),
        cice=state.cice * mask, hsnow=state.hsnow * mask,
    )
    full = lambda v: jnp.full((N, N), v, dtype)
    pf = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(12.0),
    )
    # A vortex wind over a gyre current.
    r = np.hypot(ii - 0.4, jj - 0.5) + 1e-9
    speed = 20.0 * np.minimum(r / 0.25, 0.25 / r)
    df = DynamicsForcing(
        u_atm=jnp.asarray(-speed * (jj - 0.5) / r, dtype),
        v_atm=jnp.asarray(speed * (ii - 0.4) / r, dtype),
        u_ocean=jnp.asarray(0.1 * np.sin(np.pi * ii) * np.cos(np.pi * jj), dtype),
        v_ocean=jnp.asarray(-0.1 * np.cos(np.pi * ii) * np.sin(np.pi * jj), dtype),
    )
    for _ in range(steps):
        state = model.step(state, pf, df, dt=600.0)
    return state


@pytest.mark.parametrize("case", list(CASES))
def test_f32_step_matches_f64_reference(case):
    got = _run(case, jnp.float32)
    want = _run(case, jnp.float64)
    assert got.hice.dtype == jnp.float32 and want.hice.dtype == jnp.float64
    worst = {}
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    for (path, a), b in zip(flat, jax.tree.leaves(want)):
        a = np.asarray(a, np.float64)
        b = np.asarray(b)
        assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
        scale = float(np.max(np.abs(b))) or 1.0
        worst[jax.tree_util.keystr(path)] = float(np.max(np.abs(a - b))) / scale
    name = max(worst, key=worst.get)
    assert worst[name] < TOL, (name, worst[name])
    # The dynamics moved the ice: the comparison is not of two zero fields.
    assert float(jnp.max(jnp.abs(jax.tree.leaves(want.velocity)[0]))) > 1e-4
