"""Weak-scaling harness: elements/s and efficiency vs device count.

Runs the coupled dynamics step on 1, 2, 4, ..., N devices with the
per-device problem size held fixed (weak scaling); reports throughput and
efficiency relative to 1 device. On several accelerators this exercises
the halo exchange between them; under ``JAX_PLATFORMS=cpu`` with
``--xla_force_host_platform_device_count=8`` it validates the harness.

Three multi-device paths are measurable: ``gspmd`` (auto-partitioned
global step), ``shardmap`` (explicit per-subcycle width-1 ppermute halos)
and ``blocked`` (ghost-zone exchange, one ppermute pair per axis per H
subcycles). The harness also prints each strategy's ANALYTIC per-device
communication budget (messages + bytes per coupled step) — the quantity
the strategies trade against redundant compute.

A fourth leg runs across REAL processes: ``--processes N`` spawns N
separate Python workers wired into one runtime by
``jax.distributed.initialize`` (coordinator on localhost), with the device
mesh spanning every process — the multi-host launch shape, minus the
hardware. The workers are CPU-only: the spawner pins
``JAX_PLATFORMS=cpu`` in their environment, so no two processes ever hold
one accelerator. It validates result parity against a single-device run
AND reports cross-process step timings (meaningful for the launch path,
not for absolute throughput: localhost gRPC is not an interconnect).

Usage: ``python benchmarks/scaling.py [local_n_per_device] [path ...]``
or ``python benchmarks/scaling.py --processes N [--devices-per-process K]``
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from nextsimdg_tpu.coupled import CoupledModel
from nextsimdg_tpu.dynamics import RectMesh
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
from nextsimdg_tpu.parallel import SpatialPartition, make_spatial_mesh
from nextsimdg_tpu.parallel.shardmap import build_sharded_coupled_model
from nextsimdg_tpu.state import Forcing
from nextsimdg_tpu.utils.compile_cache import enable_compile_cache

#: Ghost width of the blocked exchange in this harness.
BLOCK_HALO = 8


def comm_budget(local_n: int, n_subcycles: int = 100, itemsize: int = 4) -> dict:
    """Analytic per-device halo traffic per coupled step, by strategy.

    Counts the mEVP subcycle loop only (the dominant exchanger; transport
    adds one ghost-zone exchange per CFL-substep round). A 2-D ('X','Y')
    interior device exchanges with 4 neighbors; strip width 1 column/row
    of ``local_n`` elements per plane.
    """
    strip = local_n * itemsize
    h = BLOCK_HALO
    rounds = math.ceil(n_subcycles / h)
    # Per-subcycle ppermute: every neighbor shift of the 13-shift subcycle
    # crosses the block edge once -> ~13 strips/axis-direction-pair; JAX
    # fuses the ppermutes per shift, so messages ~ shifts x 2 axes.
    per_sub = dict(
        messages=n_subcycles * 13 * 2,
        bytes=n_subcycles * 13 * 2 * strip,
    )
    # Blocked ghost zones: one ppermute pair per axis per h subcycles,
    # carrying h-wide strips of the 12 planes (5 state + 7 consts are
    # widened per round/step respectively; count the per-round 5 + the
    # once-per-step 7).
    blocked = dict(
        messages=rounds * 2 * 2,
        bytes=(rounds * 5 + 7) * 2 * 2 * h * strip,
    )
    return {"shardmap": per_sub, "blocked": blocked}


def run_once(devices, local_n: int, chunk: int = 32, path: str = "gspmd"):
    """Return (elements/s, selected paths) for len(devices) devices,
    local_n^2 elements each."""
    mesh = make_spatial_mesh(devices=devices)
    px, py = mesh.devices.shape
    nx, ny = local_n * px, local_n * py
    dtype = jnp.float32

    rmesh = RectMesh(nx=nx, ny=ny, dx=2e3, dy=2e3)
    state_model = CoupledModel(rmesh, degree=1, n_subcycles=100)
    state = state_model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, dtype=dtype)
    full = lambda v: jnp.full((nx, ny), v, dtype)
    pf = Forcing(tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
                 lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0))
    df = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02),
                         v_ocean=full(0.0))

    part = SpatialPartition(mesh)
    state, pf, df = part.shard(state), part.shard(pf), part.shard(df)

    if path == "gspmd":
        model = state_model
        run = lambda s: model.run(s, pf, df, 600.0, chunk, do_thermo=False)
    else:
        kwargs = {}
        if path == "blocked":
            kwargs = dict(mevp_backend="blocked", mevp_block_halo=BLOCK_HALO)
        model, sharded_step = build_sharded_coupled_model(
            rmesh, mesh, degree=1, n_subcycles=100, **kwargs
        )

        def run(s):
            for _ in range(chunk):
                s = sharded_step(s, pf, df, 600.0, do_thermo=False)
            return s

    def run_synced(s):
        return jax.block_until_ready(run(s))

    state = run_synced(state)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state = run_synced(state)
        best = min(best, time.perf_counter() - t0)

    # Which mEVP exchange this cell actually runs.
    return nx * ny * chunk / best, {"mevp": model.mevp._kernel_choice()}


def run_multiprocess(num_processes: int, devices_per_process: int,
                     n: int) -> None:
    """Cross-process leg: parity + timing over a process-spanning mesh."""
    from nextsimdg_tpu.parallel.multiprocess import launch

    for count in [1, num_processes] if num_processes > 1 else [1]:
        results = launch(
            count, devices_per_process=devices_per_process,
            paths=("gspmd", "blocked"), n=n, steps=1, n_subcycles=20,
            bench_reps=3,
        )
        r0 = results[0]
        for path, entry in r0["paths"].items():
            print(json.dumps({
                "processes": count,
                "global_devices": r0["global_devices"],
                "path": path,
                "parity_error_in_tolerance_units":
                    entry["error_in_tolerance_units"],
                "elements_per_s": float(f"{entry['elements_per_s']:.4g}"),
                "global_grid": f"{n}x{n}",
            }), flush=True)


def main(argv) -> None:
    enable_compile_cache()
    args = argv[1:]
    if "--processes" in args:
        i = args.index("--processes")
        nproc = int(args[i + 1])
        dpp = 2
        if "--devices-per-process" in args:
            dpp = int(args[args.index("--devices-per-process") + 1])
        run_multiprocess(nproc, dpp, n=32)
        return
    local_n = int(args[0]) if args and args[0].isdigit() else 128
    paths = [a for a in args if not a.isdigit()] or ["gspmd"]
    devices = jax.devices()
    counts = [1]
    while counts[-1] * 2 <= len(devices):
        counts.append(counts[-1] * 2)

    for name, budget in comm_budget(local_n).items():
        print(json.dumps({
            "comm_budget_per_device_per_step": name,
            "messages": budget["messages"],
            "bytes": budget["bytes"],
            "local_grid": f"{local_n}x{local_n}",
        }), flush=True)

    for path in paths:
        base = None
        # The explicit paths dispatch per step (no scan); use a smaller
        # chunk so harness runs stay short.
        chunk = 32 if path == "gspmd" else 8
        for k in counts:
            throughput, selected = run_once(
                devices[:k], local_n, chunk=chunk, path=path
            )
            if base is None:
                base = throughput
            efficiency = throughput / (base * k)
            print(json.dumps({
                "devices": k,
                "path": path,
                "elements_per_s": float(f"{throughput:.4g}"),
                "weak_scaling_efficiency": float(f"{efficiency:.4g}"),
                "local_grid": f"{local_n}x{local_n}",
                "selected_kernels": selected,
            }), flush=True)


if __name__ == "__main__":
    main(sys.argv)
