"""A-weighted surface stresses + concentration-aware dynamics mask.

The canonical VP/mEVP momentum equation (Mehlmann & Richter box test; the
neXtSIM_DG formulation; Hibler 1979) scales BOTH surface stresses by the
ice concentration: rho H dv/dt = div(sigma) + A tau_a + A tau_w (v_w - v).
``MEVPParams(a_weighted_stress=True)`` enables that form; nodes whose
lumped concentration falls below ``a_dyn_min`` are pinned at rest (CICE's
``iceumask`` pattern), which is what keeps the weighted form stable in the
marginal ice zone where the A-scaled drag loses its damping.
"""

import jax
import jax.numpy as jnp
import numpy as np

from nextsimdg_tpu.dynamics import MEVPParams, MEVPSolver, RectMesh, VelocityState
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing


def _setup(n=16, a_value=0.9, dtype=jnp.float64):
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    h = jnp.full((n, n), 2.0, dtype)
    a = jnp.full((n, n), a_value, dtype)
    nodes = (n, n)
    forcing = DynamicsForcing(
        u_atm=jnp.full(nodes, 8.0, dtype),
        v_atm=jnp.full(nodes, 2.0, dtype),
        u_ocean=jnp.full(nodes, 0.02, dtype),
        v_ocean=jnp.zeros(nodes, dtype),
    )
    state = VelocityState.zeros(n, n, dtype=dtype)
    return mesh, h, a, forcing, state


def test_full_cover_matches_unweighted_exactly():
    """At A == 1 everywhere the weighting factors are exactly 1.0 (the
    lumped nodal concentration is node_area/node_area), so the weighted
    step must be BIT-identical to the unweighted one."""
    mesh, h, a, forcing, state = _setup(a_value=1.0)
    plain = MEVPSolver(mesh, MEVPParams(), backend="xla")
    weighted = MEVPSolver(
        mesh, MEVPParams(a_weighted_stress=True), backend="xla"
    )
    mask = plain.boundary_mask(dtype=jnp.float64)
    out_p = plain.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=20)
    out_w = weighted.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=20)
    for name in ("u", "v", "s11", "s22", "s12"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out_w, name)),
            np.asarray(getattr(out_p, name)),
            err_msg=name,
        )


def test_weighting_reduces_partial_cover_drift():
    """With 60% cover and no internal stress, free drift balances
    A tau_a = A c_w |v| v — A cancels in the balance, but the spin-up is
    slower; with internal stress off (p_star=0) the terminal speed is the
    SAME while the single-step speed is strictly smaller than unweighted
    (both stresses scaled by 0.6 < 1 from rest)."""
    mesh, h, a, forcing, state = _setup(a_value=0.6)
    params = MEVPParams(p_star=0.0, use_coriolis=False)
    plain = MEVPSolver(mesh, params, backend="xla")
    weighted = MEVPSolver(
        mesh, dataclass_replace(params, a_weighted_stress=True), backend="xla"
    )
    mask = plain.boundary_mask(dtype=jnp.float64)
    out_p = plain.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=20)
    out_w = weighted.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=20)
    sp_p = float(jnp.max(jnp.hypot(out_p.u, out_p.v)))
    sp_w = float(jnp.max(jnp.hypot(out_w.u, out_w.v)))
    assert 0.0 < sp_w < sp_p


def dataclass_replace(params, **kw):
    import dataclasses

    return dataclasses.replace(params, **kw)


def test_low_concentration_nodes_pinned():
    """Nodes whose lumped concentration is below a_dyn_min are held at
    rest (the iceumask analogue); well-covered nodes still move."""
    n = 16
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    h = jnp.full((n, n), 2.0, jnp.float64)
    # Left half nearly ice-free (A = 1e-3 < a_dyn_min), right half packed.
    a = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) < n // 2, 1e-3, 0.9
    ).astype(jnp.float64)
    nodes = (n, n)
    forcing = DynamicsForcing(
        u_atm=jnp.full(nodes, 8.0, jnp.float64),
        v_atm=jnp.full(nodes, 2.0, jnp.float64),
        u_ocean=jnp.full(nodes, 0.02, jnp.float64),
        v_ocean=jnp.zeros(nodes, jnp.float64),
    )
    solver = MEVPSolver(
        mesh, MEVPParams(a_weighted_stress=True), backend="xla"
    )
    mask = solver.boundary_mask(dtype=jnp.float64)
    state = VelocityState.zeros(n, n, dtype=jnp.float64)
    out = solver.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=50)
    u = np.asarray(out.u)
    v = np.asarray(out.v)
    # Nodes with all 4 adjacent elements in the dilute half: i <= n/2 - 1
    # reads elements i-1 and i, both dilute for 1 <= i < n//2.
    assert np.all(u[1 : n // 2, 1:] == 0.0)
    assert np.all(v[1 : n // 2, 1:] == 0.0)
    # Packed interior nodes (both adjacent element columns >= n//2+1) move.
    assert np.max(np.abs(u[n // 2 + 2 :, 1:])) > 0.0


def test_ho_weighted_unit_concentration_matches_unweighted():
    """HO: the four a_{k} planes at A = 1 reproduce the unweighted step
    bit-for-bit."""
    from nextsimdg_tpu.dynamics.mevp_ho import (
        HODynamicsForcing,
        HOField,
        HOVelocityState,
        MEVPSolverHO,
    )

    n = 16
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    h = jnp.full((n, n), 2.0, jnp.float64)
    const = lambda val: HOField.from_function(
        mesh, lambda x, y: val + 0 * x, jnp.float64
    )
    forcing = HODynamicsForcing(
        u_atm=const(8.0), v_atm=const(2.0),
        u_ocean=const(0.02), v_ocean=const(0.0),
    )
    weighted = MEVPSolverHO(
        mesh, MEVPParams(use_coriolis=False, a_weighted_stress=True)
    )
    plain = MEVPSolverHO(mesh, MEVPParams(use_coriolis=False))
    mask = weighted.boundary_mask(dtype=jnp.float64)
    state = HOVelocityState.zeros(n, n, dtype=jnp.float64)
    a1 = jnp.ones((n, n), jnp.float64)
    out_w1 = weighted.step(state, h, a1, forcing, mask, dt=600.0, n_subcycles=10)
    out_p1 = plain.step(state, h, a1, forcing, mask, dt=600.0, n_subcycles=10)
    for ax, bx in zip(jax.tree.leaves(out_w1.u), jax.tree.leaves(out_p1.u)):
        np.testing.assert_array_equal(np.asarray(ax), np.asarray(bx))


def test_shardmap_weighted_matches_single_device():
    """The a_node plane must survive the shard_map const widening: the
    sharded weighted coupled step == the single-device weighted step."""
    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.parallel import make_spatial_mesh
    from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model
    from nextsimdg_tpu.state import Forcing

    n = 16
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    params = MEVPParams(a_weighted_stress=True)
    model = CoupledModel(mesh, degree=1, n_subcycles=10, mevp_params=params)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=jnp.float64)
    full = lambda v: jnp.full((n, n), v, jnp.float64)
    pf = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    df = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    expected = model.step(state, pf, df, dt=600.0)

    device_mesh = make_spatial_mesh((4, 2))
    _, sharded_step = build_sharded_coupled_model(
        mesh, device_mesh, degree=1, n_subcycles=10, mevp_params=params
    )
    got = sharded_step(state, pf, df, 600.0)
    for a_, b_ in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
        np.testing.assert_allclose(
            np.asarray(a_), np.asarray(b_), rtol=1e-11, atol=1e-12
        )


def test_wind8_box_weighted_stays_finite():
    """The acid test that forced the round-3 revert: the wind-8 box with
    A-weighted stresses. Transport drives marginal-ice-zone elements to
    near-zero concentration at finite thickness; without the a_dyn_min
    pinning the A-scaled drag loses its damping there and the run blows
    up. With the mask the long run must stay finite and bounded."""
    from nextsimdg_tpu.coupled import CoupledModel

    n = 32
    mesh = RectMesh(nx=n, ny=n, dx=2000.0, dy=2000.0)
    model = CoupledModel(
        mesh, degree=1, n_subcycles=20,
        mevp_params=MEVPParams(a_weighted_stress=True),
    )
    assert model.auto_substeps
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05)
    full = lambda v: jnp.full((n, n), v, jnp.float32)
    df = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(8.0), u_ocean=full(0.1), v_ocean=full(0.0)
    )
    state = model.run(state, None, df, dt=600.0, n_steps=2000, do_thermo=False)
    for leaf in jax.tree.leaves(state):
        assert bool(jnp.all(jnp.isfinite(leaf)))
    assert float(jnp.max(state.cice[0])) <= 1.0 + 1e-6
    assert float(jnp.max(jnp.abs(state.velocity.u))) < 5.0
