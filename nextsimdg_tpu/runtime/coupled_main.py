"""CLI driver for the coupled dynamics+thermodynamics model.

Configured from INI/CLI like the thermo model, with a ``[dynamics]``
section:

    [model]
    start = 0
    stop = 86400
    time_step = 600
    checkpoint_period = 0           # steps between coupled checkpoints
    checkpoint_pattern = coupled.{step}.chk
    diagnostics_file =              # optional .npz time-series output
    diagnostics_period = 0
    health_period = 0               # steps between NaN/Inf state probes
    on_nonfinite = abort            # abort | retry-halved (one dt/2
                                    # replay of the failed segment)

    [dynamics]
    nx = 256
    ny = 256
    dx = 2000.0
    dy = 2000.0
    degree = 1                      # DG degree: 0, 1 or 2
    subcycles = 100
    transport_substeps = 1          # advection sub-step floor per model step
    auto_substeps = true            # CFL-adaptive sub-step count (per step)
    thermo = true
    forcing = cyclone               # constant | cyclone (native engine)
                                    # | archive:<forcing.h5> | era5:<era5.nc>
    wind = 15.0                     # constant mode / cyclone vmax
    geometry = cartesian            # cartesian | spherical (lon-lat metric)
    lat0 = 70.0                     # spherical mesh extent / era5 box
    lat1 = 80.0
    lon0 = 0.0
    lon1 = 20.0
    periodic_x = auto               # auto | true | false: wrap in x;
                                    # 'auto' = on for full 360-degree
                                    # spherical rings, off otherwise
    land_mask =                     # '' | synthetic | <mask.npy> (1=ocean)
    adaptive_alpha = false          # aEVP-style per-node alpha = beta =
                                    # max(alpha_min, c_stab sqrt(zeta dt
                                    # / (m A))) (CG1 solver)
    alpha_min = 150.0
    c_stab = 6.2832                 # ~2 pi = twice the stability bound

plus ``model.nlayers`` (ice temperature layers: 1 for ThermoIce0, 3 for
the Winton scheme selected via ``[Modules] Nextsim::IThermodynamics =
Nextsim::ThermoWinton``) and a ``[parallel]`` section for multi-chip
runs:

    [parallel]
    mode = auto                     # auto | single | gspmd | shardmap
    mesh_shape =                    # e.g. 4x2 (default: all devices,
                                    # smallest-halo factorization)
    mevp_backend = auto             # under shardmap: auto|xla (per-subcycle
                                    # ppermute) | blocked (ghost zones)
    mevp_block_halo = auto          # ghost width of the blocked exchange

``auto`` runs single-device on one device and GSPMD (auto-partitioned
global step) on several; ``shardmap`` selects the explicit SPMD driver
(per-device blocks with explicit ppermute halo exchange — the
controlled-communication path; the grid must divide the device mesh).

Run: ``python -m nextsimdg_tpu.runtime.coupled_main --config-file box.cfg``
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np

import enum

from ..config import CommandLineParser, Configurator, Configured
from ..config.enum_map import EnumWrapper
from ..utils.compile_cache import enable_compile_cache
from ..utils.logged import Logged
from ..utils.timer import main_timer


class Geometry(enum.Enum):
    CARTESIAN = "cartesian"
    SPHERICAL = "spherical"


#: Config-text -> enum converter for ``dynamics.geometry`` (an unmapped
#: token raises, reproducing EnumWrapper.hpp:58-112's validation_error).
_GEOMETRY = EnumWrapper(
    Geometry,
    {"cartesian": Geometry.CARTESIAN, "spherical": Geometry.SPHERICAL},
)


def run_coupled(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    argv = list(sys.argv if argv is None else argv)
    Configurator.set_command_line(argv)
    cmd_line = CommandLineParser(argv)
    if cmd_line.help_requested:
        return 0
    Configurator.add_files(cmd_line.get_config_file_names())

    import jax.numpy as jnp

    # Register all modules, then apply [Modules] selections from the config
    # (thermodynamics, dynamics solver, albedo, ... — same as the thermo CLI).
    import nextsimdg_tpu.physics  # noqa: F401
    import nextsimdg_tpu.dynamics  # noqa: F401
    from ..config import ConfiguredModule
    from ..modules import ModuleRegistry

    ModuleRegistry.get_loader().set_all_defaults()
    ConfiguredModule.parse_configurator()

    from ..coupled import CoupledModel
    from ..dynamics import MEVPParams, RectMesh
    from ..dynamics.mevp import DynamicsForcing
    from ..io.coupled_restart import save_coupled_state
    from ..io.diagnostics import DiagnosticWriter
    from ..state import Forcing

    get = Configured.get_configuration
    with main_timer.scope("configure"):
        start = float(get("model.start", 0.0))
        stop = float(get("model.stop", 0.0))
        dt = float(get("model.time_step", 600.0))
        checkpoint_period = int(get("model.checkpoint_period", 0))
        checkpoint_pattern = get("model.checkpoint_pattern", "coupled.{step}.chk")
        diag_file = get("model.diagnostics_file", "")
        diag_period = int(get("model.diagnostics_period", 0))
        # Failure detection (runtime/health.py; the reference has none —
        # SURVEY §5): probe the state for NaN/Inf every N steps; on
        # failure either abort (writing last-good + post-mortem
        # checkpoints) or replay the failed segment once at dt/2.
        health_period = int(get("model.health_period", 0))
        on_nonfinite = str(get("model.on_nonfinite", "abort"))

        nx = int(get("dynamics.nx", 256))
        ny = int(get("dynamics.ny", 256))
        dx = float(get("dynamics.dx", 2000.0))
        dy = float(get("dynamics.dy", 2000.0))
        degree = int(get("dynamics.degree", 1))
        subcycles = int(get("dynamics.subcycles", 100))
        transport_substeps = int(get("dynamics.transport_substeps", 1))
        auto_substeps = bool(get("dynamics.auto_substeps", True))
        tvb_m_raw = get("dynamics.tvb_m", "")
        tvb_m = float(tvb_m_raw) if str(tvb_m_raw) != "" else None
        do_thermo = bool(get("dynamics.thermo", True))
        forcing_mode = get("dynamics.forcing", "constant")
        wind = float(get("dynamics.wind", 15.0))
        geometry = _GEOMETRY(get("dynamics.geometry", "cartesian"))
        lat0 = float(get("dynamics.lat0", 70.0))
        lat1 = float(get("dynamics.lat1", 80.0))
        lon0 = float(get("dynamics.lon0", 0.0))
        lon1 = float(get("dynamics.lon1", 20.0))
        # Pan-Arctic-style coastline: 'synthetic' or a .npy path
        # (1 = ocean, 0 = land; see dynamics.landmask).
        land_mask_spec = get("dynamics.land_mask", "")
        # Ice temperature layers (cf. IStructure::nIceLayers,
        # core/src/modules/include/IStructure.hpp:62): 1 for ThermoIce0,
        # 3 for the Winton scheme ([Ts, T1, T2]).
        nlayers = int(get("model.nlayers", 1))
        init_file = get("model.init_file", "")

        # Full-ring pan-Arctic domains wrap in longitude. A 360-degree
        # span IS a ring, so the wrap defaults on there; dynamics.periodic_x
        # overrides either way (and is how Cartesian channels wrap).
        ring = abs((lon1 - lon0) - 360.0) < 1e-9
        periodic_raw = str(get("dynamics.periodic_x", "auto")).lower()
        if periodic_raw == "auto":
            periodic_x = ring and geometry is Geometry.SPHERICAL
        else:
            periodic_x = periodic_raw in ("1", "true", "yes", "on")

        if geometry is Geometry.SPHERICAL:
            from ..dynamics.mesh import SphericalMesh

            mesh = SphericalMesh(
                nx=nx, ny=ny, lon0=lon0, lon1=lon1, lat0=lat0, lat1=lat1,
                periodic_x=periodic_x,
            )
        else:
            mesh = RectMesh(nx=nx, ny=ny, dx=dx, dy=dy,
                            periodic_x=periodic_x)
        ocean_mask = None
        if land_mask_spec:
            from ..dynamics.landmask import load_ocean_mask

            ocean_mask = load_ocean_mask(land_mask_spec, nx, ny)
        # A-weighted surface stresses (the canonical VP momentum form;
        # MEVPParams.a_weighted_stress) + its MIZ pinning threshold.
        a_weighted = bool(get("dynamics.a_weighted_stress", False))
        a_dyn_min = float(get("dynamics.a_dyn_min", 5e-2))
        # Adaptive aEVP-style stabilization (MEVPParams.adaptive_alpha;
        # CG1 solver, every backend): per-node alpha=beta at the local
        # stability bound instead of one worst-case constant.
        adaptive_alpha = bool(get("dynamics.adaptive_alpha", False))
        alpha_min = float(get("dynamics.alpha_min", 150.0))
        c_stab = float(get("dynamics.c_stab", 6.2832))
        model_kwargs = dict(
            degree=degree,
            mevp_params=MEVPParams(
                a_weighted_stress=a_weighted, a_dyn_min=a_dyn_min,
                adaptive_alpha=adaptive_alpha, alpha_min=alpha_min,
                c_stab=c_stab,
            ),
            n_subcycles=subcycles, transport_substeps=transport_substeps,
            auto_substeps=auto_substeps, tvb_m=tvb_m,
            ocean_mask=ocean_mask,
        )
        model = CoupledModel(mesh, **model_kwargs)
        dtype = jnp.float32

        # Multi-chip mode ([parallel] section; see the module docstring).
        import jax

        par_mode = str(get("parallel.mode", "auto"))
        n_dev = jax.device_count()
        partition = None
        sharded_step = None
        if par_mode not in ("auto", "single", "gspmd", "shardmap"):
            raise ValueError(f"unknown parallel.mode '{par_mode}'")
        if par_mode == "auto":
            par_mode = "gspmd" if n_dev > 1 else "single"
        if par_mode in ("gspmd", "shardmap"):
            from ..parallel import SpatialPartition, make_spatial_mesh

            shape_raw = str(get("parallel.mesh_shape", ""))
            shape = (
                tuple(int(s) for s in shape_raw.lower().split("x"))
                if shape_raw else None
            )
            # Unset mesh_shape: the smallest-halo factorization that
            # divides the grid (pick_mesh_shape).
            device_mesh = make_spatial_mesh(shape, grid_shape=(nx, ny))
            partition = SpatialPartition(device_mesh)
        if par_mode == "shardmap":
            from ..parallel.shardmap import build_sharded_coupled_model

            halo_raw = str(get("parallel.mevp_block_halo", "auto"))
            _, sharded_step = build_sharded_coupled_model(
                mesh, device_mesh,
                mevp_backend=str(get("parallel.mevp_backend", "auto")),
                mevp_block_halo=(
                    "auto" if halo_raw == "auto" else int(halo_raw)
                ),
                **model_kwargs,
            )
        if init_file:
            from ..io.coupled_restart import load_coupled_state

            state = load_coupled_state(init_file, dtype=dtype)
        else:
            state = model.initial_state(
                hice0=1.0, cice0=0.9, hsnow0=0.05, nlayers=nlayers,
                dtype=dtype,
            )
            if ocean_mask is not None:
                # Land elements start (and stay) ice-free.
                m = jnp.asarray(ocean_mask, dtype)
                import dataclasses as _dc

                state = _dc.replace(
                    state,
                    hice=state.hice * m, cice=state.cice * m,
                    hsnow=state.hsnow * m,
                )

        if partition is not None:
            # Spread the global state over the device mesh; per-step
            # forcing updates stay host arrays (jit moves them).
            state = partition.shard(state)

        full = lambda v: jnp.full((nx, ny), v, dtype=dtype)
        phys_forcing = Forcing(
            tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
            lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(wind),
        )

        pipeline = None
        provider = None
        if forcing_mode.startswith("era5:"):
            # ERA5/CF netCDF reanalysis: decode + regrid once onto the model
            # mesh's lat/lon box, then run from the resulting archive.
            from ..io.era5 import era5_to_archive, lonlat_box
            from ..io.forcing_file import ForcingProvider

            if geometry is Geometry.SPHERICAL:
                dst_lats, dst_lons = mesh.lonlat_centers()
            else:
                dst_lats, dst_lons = lonlat_box(nx, ny, lat0, lat1, lon0, lon1)
            archive_path = get("dynamics.era5_archive", "era5_forcing.h5")
            era5_to_archive(
                forcing_mode.partition(":")[2], archive_path, dst_lats, dst_lons
            )
            provider = ForcingProvider(archive_path, dtype=dtype)
            dyn_forcing = provider.dynamics_forcing(start, nx, ny)
        elif forcing_mode.startswith("archive:"):
            # Time-interpolated forcing from an HDF5 archive.
            from ..io.forcing_file import ForcingProvider

            provider = ForcingProvider(forcing_mode.partition(":")[2], dtype=dtype)
            dyn_forcing = provider.dynamics_forcing(start, nx, ny)
        elif forcing_mode == "cyclone":
            from ..io.forcing_pipeline import ForcingPipeline

            pipeline = ForcingPipeline.cyclone(
                nx, ny, dx, dy, vmax_atm=wind, r0=min(nx * dx, ny * dy) / 5,
                period=4 * 86400.0, vmax_ocean=0.1, dt=dt,
            )
            dyn_forcing = None
        else:
            dyn_forcing = DynamicsForcing(
                u_atm=full(wind), v_atm=full(0.0),
                u_ocean=full(0.0), v_ocean=full(0.0),
            )

    diag = DiagnosticWriter(diag_file) if diag_file and diag_period else None
    from concurrent.futures import ThreadPoolExecutor

    from .health import HealthMonitor, NonFiniteStateError

    # One background writer: periodic checkpoints overlap with stepping
    # (single worker preserves write order; the final checkpoint joins).
    ckpt_pool = ThreadPoolExecutor(max_workers=1)
    pending_ckpt = None
    n_steps = int(round((stop - start) / dt)) if dt else 0
    Logged.info(f"Coupled run: {n_steps} steps of {dt} s on {nx}x{ny} dG{degree}")

    mon = None
    final_time = stop
    if health_period > 0:
        if on_nonfinite == "retry-halved" and pipeline is not None:
            # The native cyclone pipeline STREAMS fields (one set per
            # call at a fixed dt); a rollback cannot rewind it and
            # half-steps would desync its clock, so detection stays on
            # but recovery degrades to abort.
            Logged.warning(
                "health: retry-halved is unavailable with the streaming "
                "forcing pipeline; falling back to on_nonfinite=abort"
            )
            on_nonfinite = "abort"
        mon = HealthMonitor(health_period, on_nonfinite)

    try:
        with main_timer.scope("run"):
            if mon is not None:
                mon.record_good(0, start, state)
            # step counts completed FULL-dt steps; during a halved-dt
            # recovery segment (mon.recovering) each loop iteration is a
            # half step and `halves` tracks the intra-step position.
            step = 0
            halves = 0
            while step < n_steps:
                recovering = mon is not None and mon.recovering
                dt_cur = dt / 2 if recovering else dt
                t_now = start + step * dt + halves * (dt / 2)
                if pipeline is not None:
                    with main_timer.scope("forcing"):
                        fields = pipeline.next_fields()
                        dyn_forcing = DynamicsForcing(
                            u_atm=jnp.asarray(fields["u_atm"], dtype),
                            v_atm=jnp.asarray(fields["v_atm"], dtype),
                            u_ocean=jnp.asarray(fields["u_ocean"], dtype),
                            v_ocean=jnp.asarray(fields["v_ocean"], dtype),
                        )
                elif provider is not None:
                    with main_timer.scope("forcing"):
                        dyn_forcing = provider.dynamics_forcing(t_now, nx, ny)
                        phys_forcing = provider.thermo_forcing(t_now, nx, ny)
                with main_timer.scope("step"):
                    if sharded_step is not None:
                        state = sharded_step(
                            state, phys_forcing, dyn_forcing, dt_cur,
                            do_thermo=do_thermo,
                        )
                    else:
                        state = model.step(
                            state, phys_forcing, dyn_forcing, dt_cur,
                            do_thermo=do_thermo,
                        )
                if recovering:
                    halves += 1
                    if halves == 2:
                        halves = 0
                        step += 1
                else:
                    step += 1
                if mon is not None:
                    t_next = start + step * dt + halves * (dt / 2)
                    with main_timer.scope("health"):
                        action = mon.after_step(step, t_next, state)
                    if action == "rollback":
                        step, _t_rb, state = mon.rollback_target()
                        halves = 0
                        continue
                if halves:
                    continue  # mid-recovery half boundary: no cadence work
                in_recovery = mon is not None and mon.recovering
                if (
                    checkpoint_period and step % checkpoint_period == 0
                    and not in_recovery
                ):
                    with main_timer.scope("checkpoint"):
                        # Async: JAX arrays are immutable, so the worker
                        # thread fetches + writes while stepping
                        # continues, hidden behind the next
                        # checkpoint_period's compute. Surfacing a
                        # previous failure here keeps the one-writer
                        # ordering and loud errors.
                        if pending_ckpt is not None:
                            pending_ckpt.result()
                        pending_ckpt = ckpt_pool.submit(
                            save_coupled_state,
                            checkpoint_pattern.format(step=step), state,
                            start + step * dt,
                        )
                if diag is not None and step % diag_period == 0 and not in_recovery:
                    with main_timer.scope("diagnostics"):
                        diag.write(start + step * dt, {
                            "hice": state.hice[0], "cice": state.cice[0],
                            "hsnow": state.hsnow[0], "sst": state.sst,
                            "sss": state.sss,
                        })
    except NonFiniteStateError as err:
        # Post-mortem artifacts: the poisoned state for inspection, and
        # — via the finally block's coupled_restart.chk — the last GOOD
        # state so a resume starts from something usable.
        Logged.error(f"health: {err}")
        with main_timer.scope("post-mortem"):
            save_coupled_state("coupled_failed.post_mortem.chk", state, err.t)
            if err.last_good is not None:
                good_step, final_time, state = err.last_good
                Logged.error(
                    "health: coupled_restart.chk will hold the last "
                    f"healthy state (step {good_step}, t={final_time})"
                )
        raise
    finally:
        if diag is not None:
            diag.close()
        if pipeline is not None:
            pipeline.close()
        with main_timer.scope("final-checkpoint"):
            if pending_ckpt is not None:
                # Drain the async writer, but never let a failed PERIODIC
                # checkpoint (disk blip) stop the final restart write or
                # mask an exception from the run loop — the state in
                # memory is intact and coupled_restart.chk is the
                # artifact a resume needs.
                try:
                    pending_ckpt.result()
                except Exception as err:
                    Logged.error(f"async periodic checkpoint failed: {err}")
            save_coupled_state("coupled_restart.chk", state, time=final_time)
        ckpt_pool.shutdown(wait=True)

    print(main_timer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(run_coupled())
