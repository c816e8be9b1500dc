"""Coupled model with the higher-order (CG2/dG1) dynamics selected."""

import jax
import jax.numpy as jnp
import numpy as np

from nextsimdg_tpu.dynamics.mevp_ho import (
    HOField,
    MEVPSolverHO,
    ho_velocity_to_quad,
)
from nextsimdg_tpu.dynamics import RectMesh
from nextsimdg_tpu.dynamics.transport import sample_velocity
from nextsimdg_tpu.dynamics.dgbasis import dg_basis
from nextsimdg_tpu.modules import ModuleRegistry


def test_ho_quad_sampling_exact_for_quadratic_velocity():
    """CG2 velocity sampling at quadrature points must be exact to deg 2."""
    mesh = RectMesh(nx=8, ny=8, dx=0.125, dy=0.125)
    basis = dg_basis(2)
    fn = lambda x, y: (1.0 + x * x + 0.5 * y, 0.3 * y * y - x)
    u = HOField.from_function(mesh, lambda x, y: fn(x, y)[0])
    v = HOField.from_function(mesh, lambda x, y: fn(x, y)[1])
    qv = ho_velocity_to_quad(mesh, basis, u, v)
    qv_exact = sample_velocity(mesh, basis, fn, dtype=jnp.float64)
    sl = (slice(None), slice(None, -1), slice(None, -1))
    np.testing.assert_allclose(
        np.asarray(qv.vx_vol)[sl], np.asarray(qv_exact.vx_vol)[sl], rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(qv.vy_vol)[sl], np.asarray(qv_exact.vy_vol)[sl], rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(qv.vn_x)[:, :, :-1], np.asarray(qv_exact.vn_x)[:, :, :-1], rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(qv.vn_y)[:, :-1, :], np.asarray(qv_exact.vn_y)[:, :-1, :], rtol=1e-12
    )


def test_coupled_model_with_high_order_dynamics():
    ModuleRegistry.get_loader().set_implementation(
        "Nextsim::IDynamics", "Nextsim::MEVPHighOrder"
    )
    from tests.test_coupled import build_model

    model, state, pf, df = build_model(n=16, degree=2, n_sub=20)
    assert isinstance(model.mevp, MEVPSolverHO)
    out = model.run(state, pf, df, dt=600.0, n_steps=3)
    for leaf in jax.tree.leaves(out):
        assert np.all(np.isfinite(np.asarray(leaf)))
    # Ice moved and tracer bounds hold.
    assert float(jnp.max(jnp.abs(out.velocity.u.v))) > 0.0
    cice = np.asarray(out.cice[0])
    assert np.all(cice >= 0.0) and np.all(cice <= 1.0 + 1e-10)
