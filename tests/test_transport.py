"""DG transport tests: projection exactness, conservation, convergence.

The reference snapshot has no dynamics code, so these tests pin the
north-star contract (BASELINE.json): solid-body rotation of a tracer blob
must conserve mass to machine precision and converge with DG order.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nextsimdg_tpu.dynamics import DGTransport, RectMesh
from nextsimdg_tpu.dynamics.dgbasis import dg_basis
from nextsimdg_tpu.dynamics.transport import sample_velocity, velocity_from_cg


def test_basis_orthogonality_and_mass_diag():
    basis = dg_basis(2)
    # Gram matrix via quadrature must equal diag(mass_diag).
    gram = np.einsum("q,kq,lq->kl", basis.w_vol, basis.psi_vol, basis.psi_vol)
    np.testing.assert_allclose(gram, np.diag(basis.mass_diag), atol=1e-14)


def test_projection_reproduces_polynomials():
    mesh = RectMesh(nx=4, ny=3, dx=0.25, dy=1.0 / 3)
    basis = dg_basis(2)
    fn = lambda x, y: 1.0 + 2.0 * x + 3.0 * y + x * y + x**2
    coeffs = basis.project(fn, mesh.dx, mesh.dy, mesh.x0, mesh.y0, mesh.nx, mesh.ny)
    # Evaluate at element centers: should match fn exactly (degree <= 2).
    xc, yc = mesh.element_centers()
    values = basis.evaluate(coeffs, 0.5, 0.5)
    np.testing.assert_allclose(values, fn(xc, yc), rtol=1e-12)


def test_constant_field_is_steady_under_divergence_free_velocity():
    """A uniform tracer in a divergence-free velocity field must stay uniform."""
    mesh = RectMesh(nx=16, ny=16, dx=1 / 16, dy=1 / 16, periodic_x=True, periodic_y=True)
    transport = DGTransport(mesh, degree=2)
    vel = sample_velocity(
        mesh, transport.basis,
        lambda x, y: (np.sin(2 * np.pi * y) * 0 + 1.0, 0.5 * np.ones_like(x)),
        dtype=jnp.float64,
    )
    psi = transport.project(lambda x, y: np.ones_like(x), dtype=jnp.float64)
    out = transport.run(psi, vel, 0.001, 50)
    np.testing.assert_allclose(np.asarray(out[0]), 1.0, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(out[1:]), 0.0, atol=1e-10)


def _gaussian(x, y, cx=0.5, cy=0.7, width=0.07):
    return np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * width**2))


def _rotation(x, y):
    omega = 2 * np.pi
    return -omega * (y - 0.5), omega * (x - 0.5)


def _rotate_error(degree: int, n: int, steps_per_rev: int) -> tuple:
    mesh = RectMesh(nx=n, ny=n, dx=1.0 / n, dy=1.0 / n)
    transport = DGTransport(mesh, degree=degree)
    vel = sample_velocity(mesh, transport.basis, _rotation, dtype=jnp.float64)
    psi0 = transport.project(_gaussian, dtype=jnp.float64)
    dt = 1.0 / steps_per_rev
    psi = transport.run(psi0, vel, dt, steps_per_rev)
    err = np.sqrt(np.mean((np.asarray(psi[0]) - np.asarray(psi0[0])) ** 2))
    mass_drift = abs(
        float(transport.total_mass(psi)) - float(transport.total_mass(psi0))
    )
    return err, mass_drift


def test_solid_body_rotation_convergence_with_order():
    """One full revolution: higher DG order must reduce the L2 error."""
    steps = 1200  # CFL ~ 0.08 at n=32 for |v|max ~ 4.4
    err0, drift0 = _rotate_error(0, 32, steps)
    err1, drift1 = _rotate_error(1, 32, steps)
    err2, drift2 = _rotate_error(2, 32, steps)
    # dG0 upwind is very diffusive; dG1 and dG2 sharply better.
    assert err1 < 0.5 * err0, (err0, err1)
    assert err2 < 0.5 * err1, (err1, err2)
    # Closed walls block all fluxes: conservation is machine-exact.
    initial_mass = 2 * np.pi * 0.07**2  # integral of the blob
    assert drift0 < 1e-12 * initial_mass, drift0
    assert drift1 < 1e-12 * initial_mass, drift1
    assert drift2 < 1e-12 * initial_mass, drift2


def test_periodic_translation_returns_to_start():
    """dG2 translation once around a periodic domain: small error, exact mass."""
    n = 32
    mesh = RectMesh(nx=n, ny=n, dx=1.0 / n, dy=1.0 / n, periodic_x=True, periodic_y=True)
    transport = DGTransport(mesh, degree=2)
    vel = sample_velocity(
        mesh, transport.basis, lambda x, y: (np.ones_like(x), np.zeros_like(y)),
        dtype=jnp.float64,
    )
    psi0 = transport.project(lambda x, y: _gaussian(x, y, 0.5, 0.5), dtype=jnp.float64)
    steps = 640
    psi = transport.run(psi0, vel, 1.0 / steps, steps)
    err = np.sqrt(np.mean((np.asarray(psi[0]) - np.asarray(psi0[0])) ** 2))
    assert err < 5e-3, err
    np.testing.assert_allclose(
        float(transport.total_mass(psi)), float(transport.total_mass(psi0)), rtol=1e-12
    )


def test_velocity_from_cg_matches_analytic_for_bilinear_field():
    """CG sampling must agree with analytic sampling for a bilinear velocity.

    Owned-node layout: the comparison excludes the last element strip, whose
    upper/right corners are the implicit wall nodes (zero, not fn).
    """
    mesh = RectMesh(nx=8, ny=8, dx=0.125, dy=0.125)
    basis = dg_basis(2)
    fn = lambda x, y: (1.0 + 2.0 * x + 0.5 * y + 0.25 * x * y, 0.3 * x - 0.7 * y)
    xn, yn = mesh.node_coords()
    u, v = fn(xn, yn)
    qv_cg = velocity_from_cg(mesh, basis, jnp.asarray(u[:-1, :-1]), jnp.asarray(v[:-1, :-1]))
    qv_an = sample_velocity(mesh, basis, fn, dtype=jnp.float64)
    kw = dict(rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(qv_cg.vx_vol)[:, :-1, :-1], np.asarray(qv_an.vx_vol)[:, :-1, :-1], **kw
    )
    np.testing.assert_allclose(
        np.asarray(qv_cg.vy_vol)[:, :-1, :-1], np.asarray(qv_an.vy_vol)[:, :-1, :-1], **kw
    )
    np.testing.assert_allclose(
        np.asarray(qv_cg.vn_x)[:, :, :-1], np.asarray(qv_an.vn_x)[:, :, :-1], **kw
    )
    np.testing.assert_allclose(
        np.asarray(qv_cg.vn_y)[:, :-1, :], np.asarray(qv_an.vn_y)[:, :-1, :], **kw
    )


def test_transport_substeps_stabilize_high_cfl():
    """CoupledModel(transport_substeps=k) advects with dt/k, restoring
    stability when u dt/dx exceeds the explicit dG1/RK2 limit (~1/3)."""
    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.dynamics.mevp import DynamicsForcing

    n = 64
    dx = 1000.0
    dt = 800.0  # with free-drift-ish u ~ 0.8 m/s: CFL ~ 0.64 > 1/3
    mesh = RectMesh(nx=n, ny=8, dx=dx, dy=dx, periodic_x=True, periodic_y=True)

    def run(substeps):
        from nextsimdg_tpu.dynamics import MEVPParams

        # Free drift (no rheology) gives a steady, analytically bounded
        # velocity; only the advection stability differs between runs.
        model = CoupledModel(
            mesh, degree=1,
            mevp_params=MEVPParams(p_star=0.0, use_coriolis=False),
            n_subcycles=40, transport_substeps=substeps,
        )
        state = model.initial_state(hice0=1.0, cice0=0.8, dtype=jnp.float64)
        bump = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(n) / n)
        state = dataclasses_replace_hice(state, bump)
        full = lambda v: jnp.full((n, 8), v, jnp.float64)
        df = DynamicsForcing(
            u_atm=full(10.0), v_atm=full(0.0),
            u_ocean=full(0.0), v_ocean=full(0.0),
        )
        for _ in range(60):
            state = model.step(state, None, df, dt, do_thermo=False)
        return np.asarray(state.hice[0])

    def dataclasses_replace_hice(state, bump):
        import dataclasses as dc

        hice = state.hice.at[0].set(jnp.asarray(bump)[:, None])
        return dc.replace(state, hice=hice)

    stable = run(3)
    # The sub-stepped run stays physical at CFL ~0.65.
    assert np.all(np.isfinite(stable))
    assert stable.max() < 3.0 and stable.min() > -1e-6

    # Wiring: substeps=2 equals manually advecting twice with dt/2 from
    # the same post-mEVP velocity.
    from nextsimdg_tpu.dynamics import MEVPParams
    from nextsimdg_tpu.dynamics.transport import velocity_from_cg

    make = lambda k: CoupledModel(
        mesh, degree=1,
        mevp_params=MEVPParams(p_star=0.0, use_coriolis=False),
        n_subcycles=40, transport_substeps=k,
    )
    model2, model1 = make(2), make(1)
    state = model1.initial_state(hice0=1.0, cice0=0.8, dtype=jnp.float64)
    full = lambda v: jnp.full((n, 8), v, jnp.float64)
    df = DynamicsForcing(
        u_atm=full(10.0), v_atm=full(0.0), u_ocean=full(0.0), v_ocean=full(0.0)
    )
    out2 = model2.step(state, None, df, dt, do_thermo=False)

    vel = model1.mevp.step(
        state.velocity, state.hice[0], jnp.clip(state.cice[0], 0, 1),
        df, model1.node_mask(jnp.float64), dt, 40,
    )
    qv = velocity_from_cg(mesh, model1.transport.basis, vel.u, vel.v)
    tracers = jnp.stack([state.hice, state.cice, state.hsnow], axis=1)
    for _ in range(2):
        tracers = model1.transport.step(tracers, qv, dt / 2, limit=True)
    np.testing.assert_allclose(
        np.asarray(out2.hice), np.asarray(jnp.clip(tracers[:, 0], 0.0, None)),
        rtol=1e-12, atol=1e-13,
    )


def test_tvb_limiter_preserves_linears_periodic():
    """minmod(psi1, D+, D-) returns psi1 exactly for a smooth linear field
    (periodic mesh: no wall clamping anywhere)."""
    n = 16
    mesh = RectMesh(nx=n, ny=n, dx=1 / n, dy=1 / n, periodic_x=True, periodic_y=True)
    tr = DGTransport(mesh, degree=2, tvb_m=0.0)
    # Periodic-compatible smooth field; slopes vary but locally ~linear.
    psi = tr.project(
        lambda x, y: 2.0 + np.sin(2 * np.pi * x), dtype=jnp.float64
    )
    out = tr.limit_slopes(psi)
    # The mean is never touched.
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(psi[0]), rtol=0, atol=0)
    # A genuinely linear field: exact preservation.
    lin = tr.project(lambda x, y: 3.0 * x - 1.0 * y + 0 * x * y, dtype=jnp.float64)
    # (project of a linear on periodic mesh yields consistent D+ == psi1
    # everywhere except across the wrap seam, where the jump differs.)
    out_lin = tr.limit_slopes(lin)
    np.testing.assert_allclose(
        np.asarray(out_lin[1][1:-1, 1:-1]), np.asarray(lin[1][1:-1, 1:-1]),
        rtol=0, atol=1e-12,
    )


def test_tvb_limiter_bounds_dg2_square_wave():
    """dG2 translation of a square wave: the positivity limiter alone lets
    cell means ring above the initial maximum; the TVB slope limiter keeps
    them bounded. Mass stays machine-exact (means are untouched)."""
    n = 32
    mesh = RectMesh(nx=n, ny=n, dx=1 / n, dy=1 / n, periodic_x=True, periodic_y=True)
    vel_fn = lambda x, y: (np.ones_like(x), np.zeros_like(y))
    square = lambda x, y: ((np.abs(x - 0.5) < 0.15) & (np.abs(y - 0.5) < 0.2)).astype(float)

    results = {}
    for name, tvb_m in (("pos_only", None), ("tvb", 0.0)):
        tr = DGTransport(mesh, degree=2, tvb_m=tvb_m)
        vel = sample_velocity(mesh, tr.basis, vel_fn, dtype=jnp.float64)
        psi = tr.project(square, dtype=jnp.float64)
        mass0 = float(tr.total_mass(psi))
        dt = 1.0 / 320
        for _ in range(160):  # half a domain crossing
            psi = tr.step(psi, vel, dt, limit=True)
        results[name] = np.asarray(psi[0])
        np.testing.assert_allclose(float(tr.total_mass(psi)), mass0, rtol=1e-12)

    over_pos = results["pos_only"].max() - 1.0
    over_tvb = results["tvb"].max() - 1.0
    assert over_pos > 1e-3, over_pos   # the ringing the limiter must fix
    assert over_tvb < 1e-4, over_tvb   # bounded with TVB slopes
    assert results["tvb"].min() > -1e-12
