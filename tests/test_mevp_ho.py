"""Higher-order (CG2 velocity / dG1 stress) mEVP tests."""

import jax.numpy as jnp
import numpy as np

from nextsimdg_tpu.dynamics import MEVPParams, MEVPSolver, RectMesh, VelocityState
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
from nextsimdg_tpu.dynamics.mevp_ho import (
    HODynamicsForcing,
    HOField,
    HOVelocityState,
    MEVPSolverHO,
)


def make_mesh(n=8, dx=2.0):
    return RectMesh(nx=n, ny=n, dx=dx, dy=dx)


def test_strain_exact_for_linear_velocity():
    mesh = make_mesh()
    solver = MEVPSolverHO(mesh)
    u = HOField.from_function(mesh, lambda x, y: 2.0 * x + 0.3 * y)
    v = HOField.from_function(mesh, lambda x, y: -0.5 * x + 0.7 * y)
    e11, e22, e12 = solver.strain_rates(u, v)
    # Interior elements (the last row/col touch implicit wall nodes).
    sl = (slice(None, -1), slice(None, -1))
    np.testing.assert_allclose(np.asarray(e11[0])[sl], 2.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(e22[0])[sl], 0.7, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(e12[0])[sl], -0.1, rtol=1e-12)
    # Linear velocity => constant strain: slope coefficients vanish.
    np.testing.assert_allclose(np.asarray(e11[1:])[:, : -1, : -1], 0.0, atol=1e-12)


def test_strain_exact_for_quadratic_velocity():
    """CG2 represents quadratics exactly; strain must be exactly linear."""
    mesh = make_mesh(n=8, dx=0.5)
    solver = MEVPSolverHO(mesh)
    u = HOField.from_function(mesh, lambda x, y: x * x)  # du/dx = 2x
    v = HOField.from_function(mesh, lambda x, y: 0.0 * x)
    e11, _, _ = solver.strain_rates(u, v)
    xc, _ = mesh.element_centers()
    sl = (slice(None, -1), slice(None, -1))
    # dG1 mean = 2 x_center; x-slope coefficient = 2 * dx (per unit ref coord).
    np.testing.assert_allclose(np.asarray(e11[0])[sl], 2.0 * xc[sl], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(e11[1])[sl], 2.0 * mesh.dx, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(e11[2])[sl], 0.0, atol=1e-12)


def test_ho_stress_divergence_exact_for_linear_stress():
    """F/W must equal div(sigma) for stress linear in x/y (dG1-exact)."""
    mesh = make_mesh()
    solver = MEVPSolverHO(mesh)
    xc, yc = mesh.element_centers()
    k = jnp.zeros((3, mesh.nx, mesh.ny))
    # sigma11 = x: dG1 coeffs mean=x_c, x-slope=dx.
    s11 = k.at[0].set(jnp.asarray(xc)).at[1].set(mesh.dx)
    zero = k
    fu, fv = solver.stress_divergence(s11, zero, zero)
    weights = solver.node_weights()
    for plane in ("v", "b", "l", "c"):
        f = np.asarray(getattr(fu, plane)) / np.asarray(getattr(weights, plane))
        np.testing.assert_allclose(f[2:-2, 2:-2], 1.0, rtol=1e-10, err_msg=plane)
        f2 = np.asarray(getattr(fv, plane)) / np.asarray(getattr(weights, plane))
        np.testing.assert_allclose(f2[2:-2, 2:-2], 0.0, atol=1e-10, err_msg=plane)


def _box(n=16, wind=10.0, dtype=jnp.float64):
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    h = jnp.full((n, n), 2.0, dtype)
    a = jnp.full((n, n), 1.0, dtype)
    const = lambda val: HOField.from_function(mesh, lambda x, y: val + 0 * x, dtype)
    forcing = HODynamicsForcing(
        u_atm=const(wind), v_atm=const(0.0), u_ocean=const(0.0), v_ocean=const(0.0)
    )
    return mesh, h, a, forcing


def test_ho_free_drift_matches_drag_balance():
    params = MEVPParams(p_star=0.0, use_coriolis=False, alpha=40.0, beta=40.0)
    mesh, h, a, forcing = _box()
    solver = MEVPSolverHO(mesh, params)
    mask = solver.boundary_mask(dtype=jnp.float64)
    state = HOVelocityState.zeros(mesh.nx, mesh.ny, dtype=jnp.float64)
    for _ in range(40):
        state = solver.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=60)
    expected = np.sqrt((1.225 * 1.2e-3) / (1026.0 * 5.5e-3)) * 10.0
    for plane in ("v", "b", "l", "c"):
        interior = np.asarray(getattr(state.u, plane))[5:-5, 5:-5]
        np.testing.assert_allclose(interior, expected, rtol=2e-2, err_msg=plane)


def test_ho_box_stable_and_consistent_with_cg1():
    """Full rheology box: stable, and cell-mean velocity close to CG1's."""
    mesh, h, a, forcing = _box(n=16)
    ho = MEVPSolverHO(mesh, MEVPParams(use_coriolis=False))
    lo = MEVPSolver(mesh, MEVPParams(use_coriolis=False), backend="xla")

    state_ho = HOVelocityState.zeros(mesh.nx, mesh.ny, dtype=jnp.float64)
    mask_ho = ho.boundary_mask(dtype=jnp.float64)
    state_lo = VelocityState.zeros(mesh.nx, mesh.ny, dtype=jnp.float64)
    mask_lo = lo.boundary_mask(dtype=jnp.float64)
    nodes = (mesh.nx, mesh.ny)
    forcing_lo = DynamicsForcing(
        u_atm=jnp.full(nodes, 10.0, jnp.float64), v_atm=jnp.zeros(nodes, jnp.float64),
        u_ocean=jnp.zeros(nodes, jnp.float64), v_ocean=jnp.zeros(nodes, jnp.float64),
    )
    for _ in range(8):
        state_ho = ho.step(state_ho, h, a, forcing, mask_ho, dt=600.0, n_subcycles=100)
        state_lo = lo.step(state_lo, h, a, forcing_lo, mask_lo, dt=600.0, n_subcycles=100)

    u_ho = np.asarray(state_ho.u.v)
    u_lo = np.asarray(state_lo.u)
    assert np.all(np.isfinite(u_ho))
    # Same physics, different discretization order: fields agree to ~15%
    # of the dynamic range in the interior.
    scale = np.max(np.abs(u_lo)) + 1e-12
    diff = np.max(np.abs(u_ho[4:-4, 4:-4] - u_lo[4:-4, 4:-4]))
    assert diff < 0.25 * scale, (diff, scale)
    # Stress means are compressive at the downwind wall, like CG1.
    assert np.mean(np.asarray(state_ho.s11[0])[-3:, 4:-4]) < 0.0


def test_ho_strain_exact_on_graded_mesh():
    """Per-element metric: strain of a linear velocity is exact on a
    tensor-graded mesh."""
    dx = 1.0 + 0.2 * np.arange(8)
    dy = 2.0 - 0.1 * np.arange(8)
    mesh = RectMesh(nx=8, ny=8, dx=dx, dy=dy)
    solver = MEVPSolverHO(mesh)
    u = HOField.from_function(mesh, lambda x, y: 2.0 * x + 0.3 * y)
    v = HOField.from_function(mesh, lambda x, y: -0.5 * x + 0.7 * y)
    e11, e22, e12 = solver.strain_rates(u, v)
    sl = (slice(None, -1), slice(None, -1))
    np.testing.assert_allclose(np.asarray(e11[0])[sl], 2.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(e22[0])[sl], 0.7, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(e12[0])[sl], -0.1, rtol=1e-12)


def test_ho_stress_divergence_exact_on_graded_mesh():
    """F/W equals div(sigma) for linear stress on a graded mesh."""
    dx = 1.0 + 0.15 * np.arange(10)
    mesh = RectMesh(nx=10, ny=10, dx=dx, dy=1.7)
    solver = MEVPSolverHO(mesh)
    xc, _ = mesh.element_centers()
    k = jnp.zeros((3, mesh.nx, mesh.ny))
    # sigma11 = x: per-element dG1 x-slope is the ELEMENT'S own width.
    s11 = k.at[0].set(jnp.asarray(xc)).at[1].set(jnp.asarray(mesh.dx_array[:, None]))
    zero = k
    fu, fv = solver.stress_divergence(s11, zero, zero)
    weights = solver.node_weights()
    for plane in ("v", "b", "l", "c"):
        f = np.asarray(getattr(fu, plane)) / np.asarray(getattr(weights, plane))
        np.testing.assert_allclose(f[2:-2, 2:-2], 1.0, rtol=1e-10, err_msg=plane)


def test_ho_coupled_runs_on_spherical_mesh():
    from nextsimdg_tpu.dynamics.mesh import SphericalMesh
    from nextsimdg_tpu.modules import ModuleRegistry
    import jax

    ModuleRegistry.get_loader().set_implementation(
        "Nextsim::IDynamics", "Nextsim::MEVPHighOrder"
    )
    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.state import Forcing

    mesh = SphericalMesh(12, 12, lon0=0.0, lon1=10.0, lat0=70.0, lat1=78.0)
    model = CoupledModel(mesh, degree=1, n_subcycles=10)
    assert isinstance(model.mevp, MEVPSolverHO)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=jnp.float32)
    full = lambda v: jnp.full((12, 12), v, jnp.float32)
    pf = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    df = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    for _ in range(2):
        state = model.step(state, pf, df, dt=600.0)
    for leaf in jax.tree.leaves(state):
        assert np.all(np.isfinite(np.asarray(leaf)))
    assert state.hice.dtype == jnp.float32  # no silent f64 promotion
    assert float(jnp.max(jnp.abs(state.velocity.u.v))) > 0.0
