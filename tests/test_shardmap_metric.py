"""Non-uniform (graded/spherical) meshes under explicit shard_map.

The multi-chip fast paths must keep working when the global mesh carries a
per-element metric: each device's block of the metric is traced
(LocalMeshView dynamic-slices the global separable factors by device
coordinates), rides the solvers as metric const planes, and the blocked
ghost-zone exchange widens those planes like any other const — so the
interiors stay EXACTLY equal to the single-device result (f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from nextsimdg_tpu.coupled import CoupledModel
from nextsimdg_tpu.dynamics import RectMesh
from nextsimdg_tpu.dynamics.mesh import LocalMeshView, SphericalMesh
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing, MEVPParams, MEVPSolver, VelocityState
from nextsimdg_tpu.parallel import make_spatial_mesh
from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model
from nextsimdg_tpu.state import Forcing


def graded_mesh(n=32, periodic=False):
    """Tensor-graded: dx refined in the middle columns, dy toward y0."""
    dx = 512e3 / n * (1.0 + 0.5 * np.cos(np.linspace(0, np.pi, n)))
    dy = 512e3 / n * np.linspace(0.6, 1.4, n)
    return RectMesh(nx=n, ny=n, dx=dx, dy=dy, periodic_x=periodic, periodic_y=periodic)


def spherical_mesh(n=32):
    return SphericalMesh(nx=n, ny=n, lon0=-20.0, lon1=20.0, lat0=60.0, lat1=80.0)


def test_local_metric_matches_static_planes():
    """LocalMeshView.local_metric == the global planes' blocks, bit-exact."""
    for mesh in (graded_mesh(16), spherical_mesh(16)):
        device_mesh = make_spatial_mesh((4, 2))
        view = LocalMeshView(mesh, 4, 2)
        bx, by = view.nx, view.ny

        def grab():
            return view.local_metric(("X", "Y"), jnp.float64)

        got = jax.jit(
            jax.shard_map(
                grab, mesh=device_mesh, in_specs=(),
                out_specs={k: P("X", "Y") for k in ("dx", "dy", "area", "face_x", "face_y")},
                check_vma=False,
            )
        )()
        shape = (mesh.nx, mesh.ny)
        expect = {
            "dx": np.broadcast_to(np.asarray(mesh.dx), shape),
            "dy": np.broadcast_to(np.asarray(mesh.dy), shape),
            "area": np.broadcast_to(np.asarray(mesh.cell_area), shape),
            "face_x": np.broadcast_to(np.asarray(mesh.face_len_x), shape),
            "face_y": np.broadcast_to(np.asarray(mesh.face_len_y), shape),
        }
        for name, plane in got.items():
            np.testing.assert_array_equal(
                np.asarray(plane), expect[name], err_msg=f"{type(mesh).__name__} {name}"
            )


def test_local_view_static_metric_raises():
    view = LocalMeshView(graded_mesh(16), 4, 2)
    for attr in ("dx", "dy", "cell_area", "face_len_x", "face_len_y"):
        with pytest.raises(TypeError):
            getattr(view, attr)
    with pytest.raises(ValueError):
        LocalMeshView(RectMesh(nx=16, ny=16, dx=1.0, dy=1.0), 4, 2)


@pytest.mark.parametrize("geometry", ["graded", "spherical"])
def test_mevp_blocked_nonuniform_matches_single_device(geometry):
    """CG1 mEVP on a non-uniform global mesh under shard_map: the
    per-subcycle 'xla' path AND the ghost-zone 'blocked' path (two halo
    widths) == the single-device result."""
    n = 32
    mesh = graded_mesh(n) if geometry == "graded" else spherical_mesh(n)
    dtype = jnp.float64
    full = lambda v: jnp.full((n, n), v, dtype)
    h, a = full(2.0), full(0.95)
    df = DynamicsForcing(
        u_atm=full(10.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    state = VelocityState.zeros(n, n, dtype)

    ref = MEVPSolver(mesh, MEVPParams(), backend="xla")
    expected = ref.step(state, h, a, df, ref.boundary_mask(dtype), 600.0, 20)

    device_mesh = make_spatial_mesh((4, 2))
    local = LocalMeshView(mesh, 4, 2)
    spec = P("X", "Y")

    for backend, halo in (
        ("xla", None),
        ("blocked", 4),
        ("blocked", 5),
    ):
        kwargs = {} if halo is None else {"block_halo": halo}
        solver = MEVPSolver(
            local, MEVPParams(), backend=backend, spmd=("X", "Y"), **kwargs
        )

        def step_local(s, hh, aa, d):
            mask = solver.boundary_mask(dtype)
            return solver.step(s, hh, aa, d, mask, 600.0, 20)

        got = jax.jit(
            jax.shard_map(
                step_local,
                mesh=device_mesh,
                in_specs=(
                    jax.tree.map(lambda _: spec, state),
                    spec, spec, jax.tree.map(lambda _: spec, df),
                ),
                out_specs=jax.tree.map(lambda _: spec, state),
                check_vma=False,
            )
        )(state, h, a, df)
        for x, y in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
            # Same 1e-8 rationale as the uniform blocked test: identical
            # math, different FMA-fusion contexts, ~2x/subcycle stress
            # feedback amplification.
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-8, atol=1e-11,
                err_msg=f"{geometry} {backend} halo={halo}",
            )


@pytest.mark.parametrize("geometry", ["graded", "spherical"])
def test_mevp_ho_blocked_nonuniform_matches_single_device(geometry):
    """HO (CG2/dG1) mEVP on a non-uniform global mesh under shard_map."""
    from nextsimdg_tpu.dynamics.mevp_ho import (
        HODynamicsForcing, HOField, HOVelocityState, MEVPSolverHO,
    )

    n = 32
    mesh = graded_mesh(n) if geometry == "graded" else spherical_mesh(n)
    dtype = jnp.float64
    full = lambda v: jnp.full((n, n), v, dtype)
    h, a = full(2.0), full(0.95)
    const = lambda v: HOField(v=full(v), b=full(v), l=full(v), c=full(v))
    df = HODynamicsForcing(
        u_atm=const(10.0), v_atm=const(3.0),
        u_ocean=const(0.02), v_ocean=const(0.0),
    )
    state = HOVelocityState.zeros(n, n, dtype)

    ref = MEVPSolverHO(mesh, MEVPParams(), backend="xla")
    expected = ref.step(state, h, a, df, ref.boundary_mask(dtype), 600.0, 20)

    device_mesh = make_spatial_mesh((4, 2))
    local = LocalMeshView(mesh, 4, 2)

    def spec_of(leaf):
        nd = np.ndim(leaf)
        return P(*([None] * (nd - 2) + ["X", "Y"]))

    for backend, halo in (
        ("xla", None),
        ("blocked", 4),
        ("blocked", 5),
    ):
        kwargs = {} if halo is None else {"block_halo": halo}
        solver = MEVPSolverHO(
            local, MEVPParams(), backend=backend, spmd=("X", "Y"), **kwargs
        )

        def step_local(s, hh, aa, d):
            mask = solver.boundary_mask(dtype)
            return solver.step(s, hh, aa, d, mask, 600.0, 20)

        got = jax.jit(
            jax.shard_map(
                step_local,
                mesh=device_mesh,
                in_specs=(
                    jax.tree.map(spec_of, state),
                    P("X", "Y"), P("X", "Y"), jax.tree.map(spec_of, df),
                ),
                out_specs=jax.tree.map(spec_of, state),
                check_vma=False,
            )
        )(state, h, a, df)
        for x, y in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
            # Near-zero dG1 stress coefficients see the same FMA-fusion
            # context differences as CG1 (the 1e-8 rationale above); the
            # uniform HO test stays at 1e-12 because its scalar metric
            # keeps both programs' fusion shapes identical.
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-8, atol=1e-11,
                err_msg=f"{geometry} {backend} halo={halo}",
            )


def _coupled_setup(mesh, dtype=jnp.float64):
    n = mesh.nx
    full = lambda v: jnp.full((n, n), v, dtype=dtype)
    pf = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    df = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    return pf, df


@pytest.mark.parametrize("geometry", ["graded", "spherical"])
def test_shardmap_coupled_nonuniform_matches_single_device(geometry):
    """Full coupled step (mEVP + staged transport + thermo) on a
    non-uniform global mesh through build_sharded_coupled_model, with the
    per-subcycle AND the blocked mEVP backends."""
    n = 16
    mesh = graded_mesh(n) if geometry == "graded" else spherical_mesh(n)
    ref_model = CoupledModel(mesh, degree=1, n_subcycles=10)
    state = ref_model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=jnp.float64)
    pf, df = _coupled_setup(mesh)
    expected = ref_model.step(state, pf, df, dt=600.0)

    device_mesh = make_spatial_mesh((4, 2))
    for backend_kwargs in (
        {},
        {"mevp_backend": "blocked", "mevp_block_halo": 4},
    ):
        _, sharded_step = build_sharded_coupled_model(
            mesh, device_mesh, degree=1, n_subcycles=10, **backend_kwargs
        )
        got = sharded_step(state, pf, df, 600.0)
        for a, b in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-11,
                err_msg=f"{geometry} {backend_kwargs}",
            )


def test_shardmap_coupled_ho_spherical_matches_single_device():
    """The BASELINE config-5 shape: spherical mesh + HO dynamics +
    coastline mask, sharded over the 8-device mesh with the blocked
    ghost-zone mEVP backend."""
    from nextsimdg_tpu.dynamics.landmask import synthetic_coastline
    from nextsimdg_tpu.modules import ModuleRegistry

    ModuleRegistry.get_loader().set_implementation(
        "Nextsim::IDynamics", "Nextsim::MEVPHighOrder"
    )
    n = 16
    mesh = spherical_mesh(n)
    coast = synthetic_coastline(n)
    ref_model = CoupledModel(mesh, degree=1, n_subcycles=10, ocean_mask=coast)
    assert ref_model.is_high_order
    state = ref_model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=jnp.float64)
    pf, df = _coupled_setup(mesh)
    expected = ref_model.step(state, pf, df, dt=600.0)

    device_mesh = make_spatial_mesh((4, 2))
    _, sharded_step = build_sharded_coupled_model(
        mesh, device_mesh, degree=1, n_subcycles=10, ocean_mask=coast,
        mevp_backend="blocked", mevp_block_halo=4,
    )
    got = sharded_step(state, pf, df, 600.0)
    for a, b in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-11
        )


def test_mevp_blocked_graded_aweighted_matches_single_device():
    """Flag intersection: A-weighted stresses (extra a_node const plane)
    x graded metric planes x blocked exchange under shard_map."""
    from nextsimdg_tpu.dynamics.mevp import MEVPParams, MEVPSolver, VelocityState

    n = 32
    mesh = graded_mesh(n)
    params = MEVPParams(a_weighted_stress=True)
    dtype = jnp.float64
    full = lambda v: jnp.full((n, n), v, dtype)
    h = full(2.0)
    a = jnp.asarray(np.linspace(0.3, 1.0, n)[:, None] * np.ones((1, n)))
    df = DynamicsForcing(
        u_atm=full(10.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    state = VelocityState.zeros(n, n, dtype)

    ref = MEVPSolver(mesh, params, backend="xla")
    expected = ref.step(state, h, a, df, ref.boundary_mask(dtype), 600.0, 20)

    device_mesh = make_spatial_mesh((4, 2))
    local = LocalMeshView(mesh, 4, 2)
    spec = P("X", "Y")
    solver = MEVPSolver(
        local, params, backend="blocked", spmd=("X", "Y"),
        block_halo=4,
    )

    def step_local(s, hh, aa, d):
        mask = solver.boundary_mask(dtype)
        return solver.step(s, hh, aa, d, mask, 600.0, 20)

    got = jax.jit(
        jax.shard_map(
            step_local,
            mesh=device_mesh,
            in_specs=(
                jax.tree.map(lambda _: spec, state),
                spec, spec, jax.tree.map(lambda _: spec, df),
            ),
            out_specs=jax.tree.map(lambda _: spec, state),
            check_vma=False,
        )
    )(state, h, a, df)
    for x, y in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), rtol=1e-8, atol=1e-11
        )


# ---------------------------------------------------------------------------
# Full-ring spherical domains (periodic longitude) — the true config-5
# topology: a pan-Arctic cap wraps in longitude, so the metric slicing
# (LocalMeshView), the ring wrap (periodic_x) and the device-ring halo
# exchange all compose. Round-4 verdict missing #2.
# ---------------------------------------------------------------------------

def ring_mesh(n=32):
    """Full 0..360 longitude ring at high latitude; wraps in x."""
    return SphericalMesh(
        nx=n, ny=n, lon0=0.0, lon1=360.0, lat0=55.0, lat1=75.0,
        periodic_x=True,
    )


def test_mevp_blocked_ring_spherical_matches_single_device():
    """CG1 mEVP on the full longitude ring under shard_map: the periodic
    wrap must ride the DEVICE ring (the +x neighbor of the last device
    column is device column 0) while LocalMeshView slices each device's
    metric — xla and blocked backends."""
    n = 32
    mesh = ring_mesh(n)
    dtype = jnp.float64
    full = lambda v: jnp.full((n, n), v, dtype)
    h, a = full(2.0), full(0.95)
    df = DynamicsForcing(
        u_atm=full(10.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    state = VelocityState.zeros(n, n, dtype)

    ref = MEVPSolver(mesh, MEVPParams(), backend="xla")
    expected = ref.step(state, h, a, df, ref.boundary_mask(dtype), 600.0, 20)

    device_mesh = make_spatial_mesh((4, 2))
    local = LocalMeshView(mesh, 4, 2)
    spec = P("X", "Y")

    for backend, halo in (
        ("xla", None),
        ("blocked", 4),
        ("blocked", 5),
    ):
        kwargs = {} if halo is None else {"block_halo": halo}
        solver = MEVPSolver(
            local, MEVPParams(), backend=backend, spmd=("X", "Y"), **kwargs
        )

        def step_local(s, hh, aa, d):
            mask = solver.boundary_mask(dtype)
            return solver.step(s, hh, aa, d, mask, 600.0, 20)

        got = jax.jit(
            jax.shard_map(
                step_local,
                mesh=device_mesh,
                in_specs=(
                    jax.tree.map(lambda _: spec, state),
                    spec, spec, jax.tree.map(lambda _: spec, df),
                ),
                out_specs=jax.tree.map(lambda _: spec, state),
                check_vma=False,
            )
        )(state, h, a, df)
        for x, y in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-8, atol=1e-11,
                err_msg=f"ring {backend} halo={halo}",
            )


def test_mevp_ho_blocked_ring_spherical_matches_single_device():
    """HO (CG2/dG1) mEVP on the full longitude ring under shard_map."""
    from nextsimdg_tpu.dynamics.mevp_ho import (
        HODynamicsForcing, HOField, HOVelocityState, MEVPSolverHO,
    )

    n = 32
    mesh = ring_mesh(n)
    dtype = jnp.float64
    full = lambda v: jnp.full((n, n), v, dtype)
    h, a = full(2.0), full(0.95)
    const = lambda v: HOField(v=full(v), b=full(v), l=full(v), c=full(v))
    df = HODynamicsForcing(
        u_atm=const(10.0), v_atm=const(3.0),
        u_ocean=const(0.02), v_ocean=const(0.0),
    )
    state = HOVelocityState.zeros(n, n, dtype)

    ref = MEVPSolverHO(mesh, MEVPParams(), backend="xla")
    expected = ref.step(state, h, a, df, ref.boundary_mask(dtype), 600.0, 20)

    device_mesh = make_spatial_mesh((4, 2))
    local = LocalMeshView(mesh, 4, 2)

    def spec_of(leaf):
        nd = np.ndim(leaf)
        return P(*([None] * (nd - 2) + ["X", "Y"]))

    for backend, halo in (("xla", None), ("blocked", 4)):
        kwargs = {} if halo is None else {"block_halo": halo}
        solver = MEVPSolverHO(
            local, MEVPParams(), backend=backend, spmd=("X", "Y"), **kwargs
        )

        def step_local(s, hh, aa, d):
            mask = solver.boundary_mask(dtype)
            return solver.step(s, hh, aa, d, mask, 600.0, 20)

        got = jax.jit(
            jax.shard_map(
                step_local,
                mesh=device_mesh,
                in_specs=(
                    jax.tree.map(spec_of, state),
                    P("X", "Y"), P("X", "Y"), jax.tree.map(spec_of, df),
                ),
                out_specs=jax.tree.map(spec_of, state),
                check_vma=False,
            )
        )(state, h, a, df)
        for x, y in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-8, atol=1e-11,
                err_msg=f"ring HO {backend} halo={halo}",
            )


def test_shardmap_coupled_ring_matches_single_device():
    """Full coupled step (mEVP + transport + thermo) on the longitude
    ring through build_sharded_coupled_model, per-subcycle AND blocked
    backends — the production config-5 composition."""
    n = 16
    mesh = ring_mesh(n)
    ref_model = CoupledModel(mesh, degree=1, n_subcycles=10)
    state = ref_model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=jnp.float64
    )
    pf, df = _coupled_setup(mesh)
    expected = ref_model.step(state, pf, df, dt=600.0)

    device_mesh = make_spatial_mesh((4, 2))
    for backend_kwargs in (
        {},
        {"mevp_backend": "blocked", "mevp_block_halo": 4},
    ):
        _, sharded_step = build_sharded_coupled_model(
            mesh, device_mesh, degree=1, n_subcycles=10, **backend_kwargs
        )
        got = sharded_step(state, pf, df, 600.0)
        for a, b in zip(jax.tree.leaves(expected), jax.tree.leaves(got)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-11,
                err_msg=f"ring {backend_kwargs}",
            )
