"""Benchmark suite covering the five BASELINE.json configurations.

Usage: ``python benchmarks/run_benchmarks.py [config ...]``
Configs: dev1, advection, box, coupled_1m, multihost_16m, all (default: the
fast subset dev1+advection+box). Each result prints as one JSON line.

All timed regions are pre-compiled fixed-size ``lax.scan`` chunks that
end in ``jax.block_until_ready``, so compilation is not measured.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from nextsimdg_tpu.utils.compile_cache import enable_compile_cache


def _timed_chunk(run, state, chunk):
    import jax

    def run_synced(s):
        return jax.block_until_ready(run(s))

    state = run_synced(state)  # compile + warmup
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state = run_synced(state)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_dev1() -> dict:
    """Thermodynamics-only column physics throughput (dev1 physics, big grid).

    The reference's dev1 is a 10x10 correctness run; for a throughput number
    the same physics runs on 512x512 columns.
    """
    import jax
    import jax.numpy as jnp
    from functools import partial

    from nextsimdg_tpu.physics import NextsimPhysics
    from nextsimdg_tpu.state import dummy_forcing, PrognosticBuilder

    n = 512
    dtype = jnp.float32
    phys = NextsimPhysics()
    phys.configure()
    prog = (
        PrognosticBuilder(n, n, nlayers=1, dtype=dtype)
        .hice(0.1).cice(0.5).hsnow(0.0).sst(-1.0).sss(32.0).tice(-1.0)
        .build()
    )
    forcing = dummy_forcing(n, n, dtype=dtype)
    new_ice = jnp.zeros((n, n), dtype)
    chunk = 1000

    @partial(jax.jit, static_argnames=())
    def run(carry):
        def body(c, _):
            p, ni = c
            updated, diags = phys.step(p, forcing, ni, 600.0)
            return (updated, diags.new_ice), None

        out, _ = jax.lax.scan(body, carry, None, length=chunk)
        return out

    best = _timed_chunk(run, (prog, new_ice), chunk)
    return {
        "metric": "thermo column updates/s (dev1 physics, 512x512, f32)",
        "value": float(f"{n * n * chunk / best:.4g}"),
        "unit": "columns/s",
    }


def bench_advection(n=128, degree=2) -> dict:
    """BASELINE config 2: solid-body rotation, 128x128, dG1/dG2."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from nextsimdg_tpu.dynamics import DGTransport, RectMesh
    from nextsimdg_tpu.dynamics.transport import sample_velocity

    mesh = RectMesh(nx=n, ny=n, dx=1.0 / n, dy=1.0 / n)
    tr = DGTransport(mesh, degree=degree)
    vel = sample_velocity(
        mesh, tr.basis,
        lambda x, y: (-2 * np.pi * (y - 0.5), 2 * np.pi * (x - 0.5)),
        dtype=jnp.float32,
    )
    psi = tr.project(
        lambda x, y: np.exp(-((x - 0.5) ** 2 + (y - 0.7) ** 2) / 0.01),
        dtype=jnp.float32,
    )
    dt = 0.2 / (n * 2 * np.pi)
    chunk = 400

    @partial(jax.jit, static_argnames=())
    def run(p):
        def body(c, _):
            return tr.step(c, vel, dt), None

        out, _ = jax.lax.scan(body, p, None, length=chunk)
        return out

    best = _timed_chunk(run, psi, chunk)
    return {
        "metric": f"DG advection element updates/s (dG{degree}, {n}x{n}, f32)",
        "value": float(f"{n * n * chunk / best:.4g}"),
        "unit": "elements/s",
    }


def bench_box(n=256, n_subcycles=100) -> dict:
    """BASELINE config 3: wind-driven box, 100 mEVP subcycles, thermo off."""
    import jax
    import jax.numpy as jnp

    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.dynamics import RectMesh
    from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
    from nextsimdg_tpu.state import Forcing

    dtype = jnp.float32
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    model = CoupledModel(mesh, degree=1, n_subcycles=n_subcycles)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=dtype)
    full = lambda v: jnp.full((n, n), v, dtype)
    pf = Forcing(tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                 lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    df = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02),
                         v_ocean=full(0.0))
    chunk = 128
    run = lambda s: model.run(s, pf, df, 600.0, chunk, do_thermo=False)
    best = _timed_chunk(run, state, chunk)
    return {
        "metric": f"mEVP box element updates/s ({n}x{n}, {n_subcycles} subcycles, f32)",
        "value": float(f"{n * n * chunk / best:.4g}"),
        "unit": "elements/s",
    }


def bench_box_adaptive(n=256, n_subcycles=100) -> dict:
    """The box with aEVP-style adaptive alpha/beta (round 5)."""
    import jax.numpy as jnp

    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.dynamics import MEVPParams, RectMesh
    from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
    from nextsimdg_tpu.state import Forcing

    dtype = jnp.float32
    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    model = CoupledModel(
        mesh, degree=1, mevp_params=MEVPParams(adaptive_alpha=True),
        n_subcycles=n_subcycles,
    )
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=dtype)
    full = lambda v: jnp.full((n, n), v, dtype)
    pf = Forcing(tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                 lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    df = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02),
                         v_ocean=full(0.0))
    chunk = 128
    run = lambda s: model.run(s, pf, df, 600.0, chunk, do_thermo=False)
    best = _timed_chunk(run, state, chunk)
    return {
        "metric": f"adaptive-alpha mEVP box element updates/s ({n}x{n}, {n_subcycles} subcycles, f32)",
        "value": float(f"{n * n * chunk / best:.4g}"),
        "unit": "elements/s",
    }


def _synthetic_coastline(n: int) -> np.ndarray:
    """A pan-Arctic-style ocean mask (shared with the CLI's
    ``dynamics.land_mask = synthetic``; see dynamics/landmask.py)."""
    from nextsimdg_tpu.dynamics.landmask import synthetic_coastline

    return synthetic_coastline(n)


def bench_coupled_1m(
    n=1024, land_mask=False, spherical=False, high_order=False, chunk=16,
    a_weighted=False, periodic=False,
) -> dict:
    """BASELINE config 4: coupled thermo+dynamics, ~1M elements.

    ``land_mask=True`` adds a synthetic pan-Arctic-style coastline (the
    realistic config: impermeable coastline faces, no-slip coastal nodes);
    ``spherical=True`` runs a lon-lat mesh (per-latitude metric planes);
    ``high_order=True`` selects the CG2/dG1 neXtSIM_DG discretization;
    ``a_weighted=True`` runs the canonical A-weighted momentum form (one
    extra a_node const plane; MEVPParams.a_weighted_stress).
    """
    import jax
    import jax.numpy as jnp

    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.dynamics import RectMesh
    from nextsimdg_tpu.dynamics.mesh import SphericalMesh
    from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
    from nextsimdg_tpu.modules import ModuleRegistry
    from nextsimdg_tpu.state import Forcing

    dtype = jnp.float32
    if spherical:
        # Pan-Arctic-style window; zonal widths carry cos(latitude).
        mesh = SphericalMesh(n, n, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)
    else:
        mesh = RectMesh(
            nx=n, ny=n, dx=4e3, dy=4e3,
            periodic_x=periodic, periodic_y=periodic,
        )
    ocean = _synthetic_coastline(n) if land_mask else None
    loader = ModuleRegistry.get_loader()
    if high_order:
        loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    from nextsimdg_tpu.dynamics import MEVPParams

    try:
        model = CoupledModel(
            mesh, degree=1, n_subcycles=100, ocean_mask=ocean,
            mevp_params=MEVPParams(a_weighted_stress=a_weighted),
        )
    finally:
        if high_order:
            loader.reset()
    state = model.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, dtype=dtype)
    full = lambda v: jnp.full((n, n), v, dtype)
    pf = Forcing(tair=full(-15.0), dew2m=full(-17.0), pair=full(1e5), sw_in=full(5.0),
                 lw_in=full(240.0), mld=full(10.0), snowfall=full(1e-4), wind=full(6.0))
    df = DynamicsForcing(u_atm=full(6.0), v_atm=full(3.0), u_ocean=full(0.02),
                         v_ocean=full(0.0))
    run = lambda s: model.run(s, pf, df, 600.0, chunk)
    best = _timed_chunk(run, state, chunk)
    tags = "".join([
        ", synthetic coastline" if land_mask else "",
        ", spherical lon-lat" if spherical else "",
        ", CG2/dG1" if high_order else "",
        ", A-weighted" if a_weighted else "",
        ", periodic" if periodic else "",
    ])
    return {
        "metric": (
            f"coupled thermo+dynamics element updates/s "
            f"({n}x{n} = {n*n/1e6:.2g}M elements{tags}, f32)"
        ),
        "value": float(f"{n * n * chunk / best:.4g}"),
        "unit": "elements/s",
    }


def bench_coupled_1m_spherical_spmd(
    n=1024, chunk=16, high_order=False,
    spherical=True, coastline=True, halo="auto",
) -> dict:
    """BASELINE config 5 as it would really be run: spherical lon-lat +
    synthetic coastline, sharded over the device mesh via EXPLICIT
    shard_map — LocalMeshView metric planes through the blocked
    ghost-zone mEVP and the staged spmd transport.

    On one device the ring collectives degenerate to self-copies, so the
    figure is a single-device run of the multi-device path (labelled
    below); several devices run the same code path with real traffic.
    """
    import jax
    import jax.numpy as jnp

    from nextsimdg_tpu.dynamics.mesh import SphericalMesh
    from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
    from nextsimdg_tpu.parallel import SpatialPartition, make_spatial_mesh
    from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model
    from nextsimdg_tpu.state import Forcing

    from nextsimdg_tpu.modules import ModuleRegistry

    dtype = jnp.float32
    if spherical:
        mesh = SphericalMesh(n, n, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)
    else:
        from nextsimdg_tpu.dynamics.mesh import RectMesh

        mesh = RectMesh(nx=n, ny=n, dx=4e3, dy=4e3)
    ocean = _synthetic_coastline(n) if coastline else None
    device_mesh = make_spatial_mesh()
    loader = ModuleRegistry.get_loader()
    if high_order:
        # The REAL config-5 discretization: CG2/dG1 over the device mesh.
        loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        model, sharded_step = build_sharded_coupled_model(
            mesh, device_mesh, degree=1, n_subcycles=100, ocean_mask=ocean,
            mevp_backend="blocked", mevp_block_halo=halo,
        )
    finally:
        if high_order:
            loader.reset()
    # Global-shaped state/forcing; jit moves them onto the mesh.
    part = SpatialPartition(device_mesh)
    from nextsimdg_tpu.coupled import CoupledModel

    if high_order:
        loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        global_model = CoupledModel(mesh, degree=1, n_subcycles=100, ocean_mask=ocean)
    finally:
        if high_order:
            loader.reset()
    state = part.shard(
        global_model.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, dtype=dtype)
    )
    full = lambda v: jnp.full((n, n), v, dtype)
    pf = part.shard(Forcing(
        tair=full(-15.0), dew2m=full(-17.0), pair=full(1e5), sw_in=full(5.0),
        lw_in=full(240.0), mld=full(10.0), snowfall=full(1e-4), wind=full(6.0),
    ))
    df = part.shard(DynamicsForcing(
        u_atm=full(6.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0)
    ))

    @jax.jit
    def run(s):
        out, _ = jax.lax.scan(
            lambda c, _: (sharded_step(c, pf, df, 600.0), None),
            s, None, length=chunk,
        )
        return out

    best = _timed_chunk(run, state, chunk)
    n_dev = jax.device_count()
    scope = "1-device self-ring" if n_dev == 1 else f"{n_dev}-device"
    order = "CG2/dG1 " if high_order else ""
    geom = ("spherical" if spherical else "uniform") + (
        " + coastline" if coastline else ""
    )
    return {
        "metric": (
            f"coupled shard_map element updates/s ({n}x{n} {geom}, "
            f"{order}blocked h={model.mevp.block_halo} mEVP, {scope}, f32)"
        ),
        "value": float(f"{n * n * chunk / best:.4g}"),
        "unit": "elements/s",
    }


def bench_multihost_16m(n: int = 4096, chunk: int = 4) -> dict:
    """BASELINE config 5 (structure): 16M elements sharded over all devices.

    On several devices this runs the explicit shard_map blocked path; on
    one device it reports single-device throughput at 4096x4096.
    ``n``/``chunk`` shrink for smoke tests.
    """
    import jax
    import jax.numpy as jnp

    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.dynamics import RectMesh
    from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
    from nextsimdg_tpu.parallel import SpatialPartition, make_spatial_mesh
    from nextsimdg_tpu.state import Forcing

    dtype = jnp.float32
    mesh = RectMesh(nx=n, ny=n, dx=2e3, dy=2e3)
    model = CoupledModel(mesh, degree=1, n_subcycles=100)
    state = model.initial_state(hice0=1.2, cice0=0.95, hsnow0=0.1, dtype=dtype)
    full = lambda v: jnp.full((n, n), v, dtype)
    pf = Forcing(tair=full(-15.0), dew2m=full(-17.0), pair=full(1e5), sw_in=full(5.0),
                 lw_in=full(240.0), mld=full(10.0), snowfall=full(1e-4), wind=full(6.0))
    df = DynamicsForcing(u_atm=full(6.0), v_atm=full(3.0), u_ocean=full(0.02),
                         v_ocean=full(0.0))

    n_dev = jax.device_count()
    if n_dev > 1:
        # The explicit shard_map path with the blocked ghost-zone mEVP,
        # not GSPMD inference.
        from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model

        device_mesh = make_spatial_mesh()
        part = SpatialPartition(device_mesh)
        _, sharded_step = build_sharded_coupled_model(
            mesh, device_mesh, degree=1, n_subcycles=100,
            mevp_backend="blocked", mevp_block_halo="auto",
        )
        state = part.shard(state)
        pf = part.shard(pf)
        df = part.shard(df)

        @jax.jit
        def run(s):
            out, _ = jax.lax.scan(
                lambda c, _: (sharded_step(c, pf, df, 600.0), None),
                s, None, length=chunk,
            )
            return out
    else:
        run = lambda s: model.run(s, pf, df, 600.0, chunk)
    best = _timed_chunk(run, state, chunk)
    # On one device this is the single-device 16M figure, not a scaling
    # number (no cross-device traffic exists to measure).
    scope = (
        "single-device" if n_dev == 1
        else f"{n_dev}-device shard_map blocked"
    )
    return {
        "metric": f"full model element updates/s ({n}x{n} ~16M elements, {scope}, f32)",
        "value": float(f"{n * n * chunk / best:.4g}"),
        "unit": "elements/s",
    }


CONFIGS = {
    "dev1": bench_dev1,
    "advection": bench_advection,
    "box": bench_box,
    # Adaptive aEVP-style stabilization on the same box.
    "box_adaptive": lambda: bench_box_adaptive(),
    "coupled_1m": bench_coupled_1m,
    "coupled_1m_mask": lambda: bench_coupled_1m(land_mask=True),
    "coupled_1m_spherical": lambda: bench_coupled_1m(
        land_mask=True, spherical=True
    ),
    "coupled_1m_spherical_spmd": bench_coupled_1m_spherical_spmd,
    "ho_coupled_1m_spherical_spmd": lambda: bench_coupled_1m_spherical_spmd(
        chunk=8, high_order=True
    ),
    # HO spmd ablation: peel the full config back one axis at a time
    # against single-device ho_coupled_1m.
    "ho_ablate_uniform_spmd": lambda: bench_coupled_1m_spherical_spmd(
        chunk=8, high_order=True, spherical=False, coastline=False
    ),
    "ho_ablate_spherical_spmd": lambda: bench_coupled_1m_spherical_spmd(
        chunk=8, high_order=True, coastline=False
    ),
    "ho_ablate_h16_spmd": lambda: bench_coupled_1m_spherical_spmd(
        chunk=8, high_order=True, halo=16
    ),
    "ho_ablate_h32_spmd": lambda: bench_coupled_1m_spherical_spmd(
        chunk=8, high_order=True, halo=32
    ),
    # BASELINE config 5 at FULL size: 16M spherical + coastline through
    # the explicit spmd path.
    "spherical_16m_spmd": lambda: bench_coupled_1m_spherical_spmd(
        n=4096, chunk=4
    ),
    # The FLAGSHIP discretization at FULL size: 16M CG2/dG1 spherical +
    # coastline spmd.
    "ho_spherical_16m_spmd": lambda: bench_coupled_1m_spherical_spmd(
        n=4096, chunk=2, high_order=True
    ),
    # The same full-size spherical domain through the single-device path.
    "spherical_16m": lambda: bench_coupled_1m(
        n=4096, land_mask=True, spherical=True, chunk=4
    ),
    "coupled_1m_aweighted": lambda: bench_coupled_1m(a_weighted=True),
    "ho_coupled_256": lambda: bench_coupled_1m(n=256, high_order=True, chunk=64),
    "ho_coupled_512": lambda: bench_coupled_1m(n=512, high_order=True, chunk=32),
    "ho_coupled_1m": lambda: bench_coupled_1m(high_order=True, chunk=8),
    "ho_coupled_1m_periodic": lambda: bench_coupled_1m(
        high_order=True, chunk=8, periodic=True
    ),
    "multihost_16m": bench_multihost_16m,
}


def main(argv) -> None:
    enable_compile_cache()
    names = argv[1:] or ["dev1", "advection", "box"]
    if names == ["all"]:
        names = list(CONFIGS)
    for name in names:
        result = CONFIGS[name]()
        result["config"] = name
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv)
