"""mEVP solver tests.

No reference dynamics exists; these pin physically checkable invariants:
exact strain rates for (bi)linear velocity, zero interior force for constant
stress, free-drift wind/water drag balance, and bounded stresses in the
wind-driven box benchmark (BASELINE.json config 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nextsimdg_tpu.dynamics import MEVPParams, MEVPSolver, RectMesh, VelocityState
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing, cell_to_node


def test_strain_rates_exact_for_linear_velocity():
    mesh = RectMesh(nx=8, ny=6, dx=0.5, dy=0.25)
    solver = MEVPSolver(mesh)
    xn, yn = mesh.node_coords()
    # Owned-node layout: nodes (i, j) for i < nx, j < ny.
    u = jnp.asarray((2.0 * xn + 0.3 * yn)[:-1, :-1])
    v = jnp.asarray((-0.5 * xn + 0.7 * yn)[:-1, :-1])
    e11, e22, e12 = solver.strain_rates(u, v)
    # Interior elements (the last row/column sees the implicit wall nodes).
    np.testing.assert_allclose(np.asarray(e11)[:-1, :-1], 2.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(e22)[:-1, :-1], 0.7, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(e12)[:-1, :-1], 0.5 * (0.3 - 0.5), rtol=1e-12
    )


def test_stress_divergence_exact_for_linear_stress():
    """F/area must equal div(sigma) exactly for (bi)linear stress fields."""
    mesh = RectMesh(nx=8, ny=8, dx=2.0, dy=2.0)
    solver = MEVPSolver(mesh)
    xc, yc = mesh.element_centers()
    area = mesh.dx * mesh.dy
    zero = jnp.zeros_like(jnp.asarray(xc))

    fu, fv = solver.stress_divergence(jnp.asarray(xc), zero, zero)
    np.testing.assert_allclose(np.asarray(fu)[2:-1, 2:-1] / area, 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(fv)[2:-1, 2:-1] / area, 0.0, atol=1e-12)

    fu, fv = solver.stress_divergence(zero, jnp.asarray(yc), zero)
    np.testing.assert_allclose(np.asarray(fv)[2:-1, 2:-1] / area, 1.0, rtol=1e-12)

    fu, fv = solver.stress_divergence(zero, zero, jnp.asarray(yc + 2 * xc))
    np.testing.assert_allclose(np.asarray(fu)[2:-1, 2:-1] / area, 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(fv)[2:-1, 2:-1] / area, 2.0, rtol=1e-12)


def test_constant_stress_gives_zero_interior_force():
    mesh = RectMesh(nx=8, ny=8, dx=1.0, dy=1.0)
    solver = MEVPSolver(mesh)
    s = jnp.ones((8, 8))
    fu, fv = solver.stress_divergence(s, s, 0.0 * s)
    # Interior nodes: contributions cancel.
    np.testing.assert_allclose(np.asarray(fu)[1:, 1:], 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(fv)[1:, 1:], 0.0, atol=1e-12)
    # Wall nodes feel the uncompensated edge (nonzero).
    assert np.max(np.abs(np.asarray(fu)[0, :])) > 0


def test_cell_to_node_constant_field():
    c = jnp.full((5, 4), 3.5)
    n = cell_to_node(c)
    assert n.shape == (5, 4)
    # Interior nodes average 4 equal cells; wall nodes see zero fill.
    np.testing.assert_allclose(np.asarray(n)[1:, 1:], 3.5, rtol=1e-12)


def _box_setup(n=32, wind=10.0, h0=2.0, a0=1.0, dtype=jnp.float64):
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    h = jnp.full((n, n), h0, dtype=dtype)
    a = jnp.full((n, n), a0, dtype=dtype)
    nodes = (n, n)
    forcing = DynamicsForcing(
        u_atm=jnp.full(nodes, wind, dtype=dtype),
        v_atm=jnp.zeros(nodes, dtype=dtype),
        u_ocean=jnp.zeros(nodes, dtype=dtype),
        v_ocean=jnp.zeros(nodes, dtype=dtype),
    )
    return mesh, h, a, forcing


def test_free_drift_matches_drag_balance():
    """With no ice strength and no Coriolis, u -> sqrt(ra Ca / rw Cw) U."""
    # mEVP converges ~ n_subcycles/beta of the way per outer step, so use a
    # small beta for a tight convergence test.
    params = MEVPParams(p_star=0.0, use_coriolis=False, alpha=40.0, beta=40.0)
    mesh, h, a, forcing = _box_setup()
    solver = MEVPSolver(mesh, params)
    state = VelocityState.zeros(mesh.nx, mesh.ny, dtype=jnp.float64)
    mask = solver.boundary_mask(dtype=jnp.float64)
    for _ in range(40):
        state = solver.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=60)
    expected = np.sqrt(
        (params.rho_atm * params.cd_atm) / (params.rho_ocean * params.cd_ocean)
    ) * 10.0
    interior_u = np.asarray(state.u)[8:-8, 8:-8]
    np.testing.assert_allclose(interior_u, expected, rtol=2e-2)
    assert np.max(np.abs(np.asarray(state.v)[8:-8, 8:-8])) < 0.02 * expected


def test_box_benchmark_wind_driven_drift_is_stable_and_bounded():
    """Wind-driven box with full rheology: bounded velocity, finite stress,
    compressive stress against the downwind wall."""
    mesh, h, a, forcing = _box_setup(n=32)
    solver = MEVPSolver(mesh, MEVPParams(use_coriolis=True))
    state = VelocityState.zeros(mesh.nx, mesh.ny, dtype=jnp.float64)
    mask = solver.boundary_mask(dtype=jnp.float64)
    for _ in range(10):
        state = solver.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=100)
    u = np.asarray(state.u)
    v = np.asarray(state.v)
    assert np.all(np.isfinite(u)) and np.all(np.isfinite(v))
    free_drift = 0.0161 * 10.0
    assert np.max(np.abs(u)) < 2.0 * free_drift
    # Downwind (east) interior: ice pushes against the wall -> compressive
    # normal stress (negative s11) near the right boundary.
    s11 = np.asarray(state.s11)
    assert np.mean(s11[-4:, 8:-8]) < 0.0
    # Stored wall nodes pinned (the i=nx / j=ny walls are implicit zeros).
    assert np.all(u[0, :] == 0) and np.all(v[0, :] == 0)
    assert np.all(u[:, 0] == 0) and np.all(v[:, 0] == 0)


def test_mevp_subcycling_converges_toward_vp_fixed_point():
    """More subcycles => closer to the VP fixed point (smaller update norm)."""
    mesh, h, a, forcing = _box_setup(n=16)
    # Stability needs alpha*beta >> zeta_max*dt*pi^2/(m*dx^2) (~4.5e3 here),
    # hence the standard alpha=beta=1500; convergence is then ~(1-1/beta)^p.
    solver = MEVPSolver(mesh, MEVPParams(use_coriolis=False))
    mask = solver.boundary_mask(dtype=jnp.float64)

    # The practical algorithm: outer steps of N subcycles, u_n refreshed each
    # step, drive the state to the VP steady solution under steady forcing —
    # the outer-step velocity increment must shrink strongly.
    state = VelocityState.zeros(mesh.nx, mesh.ny, dtype=jnp.float64)
    deltas = []
    for _ in range(12):
        nxt = solver.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=1000)
        deltas.append(float(jnp.max(jnp.abs(nxt.u - state.u))))
        state = nxt
    assert deltas[-1] < 0.08 * max(deltas), deltas
    # And the steady state is a genuine ice-internal-stress regime:
    # compressive stress of order the ice strength at the downwind wall.
    p_strength = 27500.0 * 2.0
    assert float(jnp.min(state.s11)) < -0.5 * p_strength
    assert float(jnp.min(state.s11)) > -2.0 * p_strength


def test_pick_block_halo_alignment():
    """The auto exchange halo is the fixed default, clamped so that the
    h-wide exchange strips fit inside the local block."""
    from nextsimdg_tpu.dynamics.mevp import pick_block_halo

    assert pick_block_halo(256, 256) == 16
    assert pick_block_halo(1024, 1024) == 16
    assert pick_block_halo(16, 8) == 8   # capped by the block
    assert pick_block_halo(3, 40) == 3


@pytest.mark.parametrize(
    "backend", ["pallas", "pallas-interpret", "rdma", "banded", "tiled"]
)
def test_unknown_backend_raises(backend):
    """Backend strings outside BACKENDS raise ValueError naming the
    accepted ones, for both discretizations."""
    from nextsimdg_tpu.dynamics.mevp import BACKENDS
    from nextsimdg_tpu.dynamics.mevp_ho import MEVPSolverHO

    mesh = RectMesh(nx=8, ny=8, dx=1.0, dy=1.0)
    for cls in (MEVPSolver, MEVPSolverHO):
        with pytest.raises(ValueError, match="accepted: " + ", ".join(BACKENDS)):
            cls(mesh, MEVPParams(), backend=backend)


def test_adaptive_alpha_equivalent_to_fixed_when_clamped():
    """c_stab=0 collapses the adaptive form onto alpha=beta=alpha_min;
    only the (rewritten) division order differs from the fixed path."""
    mesh, h, a, forcing = _box_setup(n=16)
    mask_params = dict(use_coriolis=False)
    fixed = MEVPSolver(mesh, MEVPParams(**mask_params))
    adapt = MEVPSolver(
        mesh,
        MEVPParams(
            **mask_params, adaptive_alpha=True, alpha_min=1500.0, c_stab=0.0
        ),
    )
    s0 = VelocityState.zeros(16, 16, dtype=jnp.float64)
    m = fixed.boundary_mask(dtype=jnp.float64)
    sf = sa = s0
    for _ in range(3):
        sf = fixed.step(sf, h, a, forcing, m, dt=600.0, n_subcycles=300)
        sa = adapt.step(sa, h, a, forcing, m, dt=600.0, n_subcycles=300)
    np.testing.assert_allclose(
        np.asarray(sa.u), np.asarray(sf.u), rtol=0, atol=1e-14
    )


def test_adaptive_alpha_reaches_the_same_vp_fixed_point():
    """Adaptive alpha=beta solves the SAME VP problem: its steady state
    matches a deeply-converged fixed-alpha run to ~1e-10 relative, and
    it gets there orders of magnitude faster at equal subcycle budget
    (each node relaxes at its own stability bound instead of the global
    worst case)."""
    mesh, h, a, forcing = _box_setup(n=16)
    m = MEVPSolver(mesh).boundary_mask(dtype=jnp.float64)

    def converge(params, steps, subs):
        s = MEVPSolver(mesh, params)
        st = VelocityState.zeros(16, 16, dtype=jnp.float64)
        deltas = []
        for _ in range(steps):
            nxt = s.step(st, h, a, forcing, m, dt=600.0, n_subcycles=subs)
            deltas.append(float(jnp.max(jnp.abs(nxt.u - st.u))))
            st = nxt
        return st, deltas

    adapt, d_adapt = converge(
        MEVPParams(use_coriolis=False, adaptive_alpha=True), 12, 1000
    )
    # Reference: small fixed alpha + a 5x subcycle budget converges too.
    fixed, _ = converge(
        MEVPParams(use_coriolis=False, alpha=200.0, beta=200.0), 30, 2000
    )
    den = float(jnp.max(jnp.abs(fixed.u)))
    rel = float(jnp.max(jnp.abs(adapt.u - fixed.u))) / den
    assert rel < 1e-8, rel
    # Convergence at equal budget: the fixed default (1500) stalls near
    # 6e-4 after 12x1000 subcycles (see the VP convergence test); the
    # adaptive run must be deep into the fixed point.
    assert d_adapt[-1] < 1e-10, d_adapt


def test_adaptive_alpha_free_drift_unchanged():
    """With zero ice strength zeta=0, so the adaptive alpha sits at its
    floor and free drift still reaches the analytic drag balance."""
    params = MEVPParams(
        p_star=0.0, use_coriolis=False, adaptive_alpha=True, alpha_min=40.0
    )
    mesh, h, a, forcing = _box_setup()
    solver = MEVPSolver(mesh, params)
    state = VelocityState.zeros(mesh.nx, mesh.ny, dtype=jnp.float64)
    mask = solver.boundary_mask(dtype=jnp.float64)
    for _ in range(40):
        state = solver.step(state, h, a, forcing, mask, dt=600.0, n_subcycles=60)
    expected = np.sqrt(
        (params.rho_atm * params.cd_atm) / (params.rho_ocean * params.cd_ocean)
    ) * 10.0
    np.testing.assert_allclose(
        np.asarray(state.u)[8:-8, 8:-8], expected, rtol=2e-2
    )


def test_adaptive_alpha_graded_mesh_stable_and_converges():
    """On a strongly graded mesh (1->32 km cells) the adaptive form is
    stable from a low floor and converges; no global retuning needed."""
    n = 32
    dxs = 1e3 + 31e3 * 0.5 * (
        1 - np.cos(2 * np.pi * (np.arange(n) + 0.5) / n)
    )
    dxs = np.roll(dxs, n // 2)  # finest cells mid-domain
    mesh = RectMesh(nx=n, ny=n, dx=dxs, dy=dxs.copy())
    h = jnp.full((n, n), 2.0)
    a = jnp.full((n, n), 1.0)
    forcing = DynamicsForcing(
        u_atm=jnp.full((n, n), 15.0), v_atm=jnp.full((n, n), 5.0),
        u_ocean=jnp.zeros((n, n)), v_ocean=jnp.zeros((n, n)),
    )
    solver = MEVPSolver(
        mesh, MEVPParams(use_coriolis=False, adaptive_alpha=True, alpha_min=25.0)
    )
    st = VelocityState.zeros(n, n, dtype=jnp.float64)
    m = solver.boundary_mask(dtype=jnp.float64)
    deltas = []
    for _ in range(12):
        nxt = solver.step(st, h, a, forcing, m, dt=600.0, n_subcycles=120)
        deltas.append(float(jnp.max(jnp.abs(nxt.u - st.u))))
        st = nxt
    assert np.all(np.isfinite(np.asarray(st.u)))
    assert deltas[-1] < 0.05 * max(deltas), deltas
