"""Real multi-process execution and validation, on the CPU.

Everything else in ``parallel/`` runs N *devices in one process*; this
module runs the model across N *processes* — the multi-host shape, where
``jax.distributed.initialize`` wires processes into one runtime,
``jax.devices()`` becomes the GLOBAL device list, and the same SPMD
program runs on every host with collectives crossing process boundaries
(SURVEY.md §2.3/§5).

Two pieces:

* :func:`worker_main` — one process of an N-process run. Initializes
  ``jax.distributed`` against a coordinator, assembles GLOBAL sharded
  arrays from process-local data (``jax.make_array_from_callback``),
  steps the coupled model over a mesh spanning every process, gathers the
  result (``multihost_utils.process_allgather``) and compares it against
  an uninterrupted single-device run of the same program.
* :func:`launch` — spawn coordinator + workers on localhost over the CPU
  backend (each process contributing ``devices_per_process`` virtual
  devices), collect their JSON verdicts. This validates the code path a
  multi-host launch uses — process-spanning collectives, global-array
  assembly, ``distributed.initialize`` — without several hosts.

The workers are CPU-only, always: the spawned environment pins
``JAX_PLATFORMS=cpu`` and each worker pins the CPU platform again, so
they never compete for an accelerator (a JAX process reserves most of a
card's memory; one process drives all the cards of a host).

Reference: the C++ reference has no multi-host layer (CMakeLists.txt:43-46
builds single-process only); this is the capability SURVEY §5 specifies
in its place.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

#: Leaf-tolerances for the cross-process vs single-device comparison
#: (f64 CPU; same budget as tests/test_shardmap.py multi-step checks).
RTOL, ATOL = 1e-10, 1e-11


# ---------------------------------------------------------------------------
# Worker side (runs in a spawned process)
# ---------------------------------------------------------------------------

def _assemble_global(tree, part):
    """Build GLOBAL jax.Arrays from replicated host values.

    Each process holds the full (deterministically computed) numpy value
    and contributes only its addressable shards; the result is one global
    array per leaf, sharded over the cross-process mesh. This is the
    multi-process generalization of ``SpatialPartition.shard`` (which
    device_puts whole arrays — a single-process luxury).
    """
    import jax
    import numpy as np

    def leaf_to_global(leaf):
        arr = np.asarray(leaf)
        sharding = part.sharding_for(arr)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    return jax.tree.map(leaf_to_global, tree)


def _gather_global(tree):
    """Fetch every leaf's full global value as numpy (on all processes)."""
    import jax
    from jax.experimental import multihost_utils

    return jax.tree.map(
        lambda leaf: multihost_utils.process_allgather(leaf, tiled=True),
        tree,
    )


def _build_problem(nx, ny, n_subcycles, dtype, spherical_ring=False,
                   **model_kwargs):
    import jax.numpy as jnp

    from ..coupled import CoupledModel
    from ..dynamics import RectMesh
    from ..dynamics.mevp import DynamicsForcing
    from ..state import Forcing

    if spherical_ring:
        # The config-5 topology: full 360-degree longitude ring — under
        # shard_map the wrap ppermute crosses PROCESS boundaries here.
        from ..dynamics.mesh import SphericalMesh

        mesh = SphericalMesh(nx=nx, ny=ny, lon0=0.0, lon1=360.0,
                             lat0=55.0, lat1=75.0, periodic_x=True)
    else:
        mesh = RectMesh(nx=nx, ny=ny, dx=512e3 / nx, dy=512e3 / ny)
    model = CoupledModel(mesh, degree=1, n_subcycles=n_subcycles,
                         **model_kwargs)
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05,
                                dtype=dtype)
    full = lambda v: jnp.full((nx, ny), v, dtype=dtype)
    pf = Forcing(tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5),
                 sw_in=full(10.0), lw_in=full(250.0), mld=full(10.0),
                 snowfall=full(1e-4), wind=full(8.0))
    df = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0),
                         u_ocean=full(0.02), v_ocean=full(0.0))
    return mesh, model, state, pf, df


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--paths", default="gspmd,blocked")
    ap.add_argument("--n", type=int, default=16, help="global grid edge")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--n-subcycles", type=int, default=10)
    ap.add_argument("--bench-reps", type=int, default=0,
                    help="extra timed reps per path (0 = validate only)")
    args = ap.parse_args(argv)

    import jax

    # CPU-only workers, f64 validation (see the module docstring).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # Must precede any backend initialization (jax.devices() etc.).
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax.numpy as jnp
    import numpy as np

    from .sharding import SpatialPartition, make_spatial_mesh
    from .shardmap import build_sharded_coupled_model

    result = {
        "process_id": args.process_id,
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
        "paths": {},
        "ok": True,
    }
    try:
        assert jax.process_count() == args.num_processes, (
            jax.process_count(), args.num_processes)

        device_mesh = make_spatial_mesh()  # spans ALL processes' devices
        part = SpatialPartition(device_mesh)
        px, py = device_mesh.devices.shape
        n = args.n
        # f64 at the suite's tolerance budget.
        dtype, rtol, atol = jnp.float64, RTOL, ATOL

        for path_name in args.paths.split(","):
            # '<path>-ring' runs the same exchange path on the config-5
            # topology (spherical 360-degree ring, LocalMeshView).
            path = path_name.removesuffix("-ring")
            mesh, model, state0, pf, df = _build_problem(
                n, n, args.n_subcycles, dtype,
                spherical_ring=path_name.endswith("-ring"))
            # Single-device reference: every process computes it locally
            # (tiny problem, deterministic) — the global run must match.
            ref = state0
            for _ in range(args.steps):
                ref = model.step(ref, pf, df, dt=600.0)
            ref = jax.tree.map(np.asarray, ref)

            if path == "gspmd":
                g_state = _assemble_global(state0, part)
                g_pf = _assemble_global(pf, part)
                g_df = _assemble_global(df, part)
                step = lambda s: model.step(s, g_pf, g_df, dt=600.0)
            elif path in ("blocked", "shardmap"):
                kwargs = {}
                if path == "blocked":
                    kwargs = dict(mevp_backend="blocked", mevp_block_halo=4)
                _, sharded_step = build_sharded_coupled_model(
                    mesh, device_mesh, degree=1,
                    n_subcycles=args.n_subcycles, **kwargs)
                g_state = _assemble_global(state0, part)
                g_pf = _assemble_global(pf, part)
                g_df = _assemble_global(df, part)
                step = lambda s: sharded_step(s, g_pf, g_df, 600.0)
            else:
                raise ValueError(f"unknown path {path!r}")

            got = g_state
            for _ in range(args.steps):
                got = step(got)
            got_np = _gather_global(got)

            # Error in tolerance units: max over elements of
            # |b-a| / (atol + rtol*|a|); <= 1.0 means within tolerance.
            worst = 0.0
            for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got_np)):
                a, b = np.asarray(a), np.asarray(b)
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
                worst = max(worst, float(np.max(
                    np.abs(b - a) / (atol + rtol * np.abs(a)))))

            entry = {"error_in_tolerance_units": worst, "mesh": f"{px}x{py}"}

            # Failure-detection probe on the PROCESS-SPANNING global
            # state (the multi-host case the jitted reduction exists for:
            # eager ops raise on non-addressable shards). Every process
            # participates in the collective and gets the same bool.
            from ..runtime.health import finite_probe

            entry["finite_probe"] = bool(finite_probe(got))
            poisoned = jax.tree.map(lambda x: x * jnp.nan, got)
            entry["finite_probe_detects"] = not finite_probe(poisoned)

            if path_name == "gspmd":
                # Multi-host checkpointing: save_coupled_state gathers
                # every leaf collectively (all processes participate) and
                # process 0 alone writes the file — round-trip it against
                # the gathered reference.
                from ..io.coupled_restart import (
                    load_coupled_state, save_coupled_state,
                )

                ckpt = os.path.join(
                    os.path.dirname(args.out), "mp_checkpoint.chk")
                save_coupled_state(ckpt, got, time=123.0)
                if args.process_id == 0:
                    loaded = load_coupled_state(ckpt, dtype=dtype)
                    for x, y in zip(jax.tree.leaves(got_np),
                                    jax.tree.leaves(loaded)):
                        np.testing.assert_array_equal(
                            np.asarray(y), np.asarray(x))
                entry["checkpoint"] = "gathered-written-once-roundtripped"
            if args.bench_reps:
                # Warm (compiled above); time whole-step round trips.
                best = float("inf")
                for _ in range(args.bench_reps):
                    t0 = time.perf_counter()
                    out = step(got)
                    jax.block_until_ready(out)
                    best = min(best, time.perf_counter() - t0)
                entry["elements_per_s"] = n * n / best
                entry["step_seconds"] = best
            result["paths"][path_name] = entry
    except Exception as err:  # report, don't hang the launcher
        result["ok"] = False
        result["error"] = f"{type(err).__name__}: {err}"
    finally:
        try:
            jax.distributed.shutdown()
        except Exception:
            pass

    with open(args.out, "w") as fh:
        json.dump(result, fh)
    return 0 if result["ok"] else 1


# ---------------------------------------------------------------------------
# Launcher side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    num_processes: int,
    devices_per_process: int = 2,
    paths: Sequence[str] = ("gspmd", "blocked"),
    n: int = 16,
    steps: int = 2,
    n_subcycles: int = 10,
    bench_reps: int = 0,
    out_dir: Optional[str] = None,
    timeout: float = 600.0,
) -> list:
    """Spawn an N-process CPU-backend run on localhost; return its verdicts.

    Each worker is a fresh Python process with its own JAX runtime and
    ``devices_per_process`` forced CPU devices; together they form one
    global ``num_processes * devices_per_process``-device mesh. Raises on
    timeout or a failed worker; returns the per-process result dicts.
    """
    import tempfile

    own_tmp = None
    if out_dir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="nextsim_mp_")
        out_dir = own_tmp.name
    coordinator = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append(
        f"--xla_force_host_platform_device_count={devices_per_process}")
    env["XLA_FLAGS"] = " ".join(flags)

    outs, procs = [], []
    try:
        for i in range(num_processes):
            out = os.path.join(out_dir, f"proc{i}.json")
            outs.append(out)
            cmd = [
                sys.executable, "-m", "nextsimdg_tpu.parallel.multiprocess",
                "--worker", "--coordinator", coordinator,
                "--num-processes", str(num_processes),
                "--process-id", str(i), "--out", out,
                "--paths", ",".join(paths), "--n", str(n),
                "--steps", str(steps), "--n-subcycles", str(n_subcycles),
                "--bench-reps", str(bench_reps),
            ]
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        tails = []
        for p in procs:
            remaining = max(1.0, deadline - time.monotonic())
            try:
                stdout, _ = p.communicate(timeout=remaining)
            except subprocess.TimeoutExpired:
                for q in procs:  # exact PIDs we spawned, never a pattern
                    q.kill()
                raise RuntimeError(
                    f"multiprocess run timed out after {timeout}s")
            tails.append(stdout[-2000:] if stdout else "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    results = []
    for i, out in enumerate(outs):
        if not os.path.exists(out):
            raise RuntimeError(
                f"worker {i} produced no result (rc={procs[i].returncode});"
                f" tail:\n{tails[i]}")
        with open(out) as fh:
            results.append(json.load(fh))
    if own_tmp is not None:
        own_tmp.cleanup()
    for r in results:
        if not r["ok"]:
            raise RuntimeError(
                f"worker {r['process_id']} failed: {r.get('error')}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--worker" in argv:
        argv.remove("--worker")
        return worker_main(argv)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=2)
    ap.add_argument("--paths", default="gspmd,blocked")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--bench-reps", type=int, default=0)
    args = ap.parse_args(argv)
    results = launch(
        args.num_processes, args.devices_per_process,
        paths=args.paths.split(","), n=args.n, steps=args.steps,
        bench_reps=args.bench_reps,
    )
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
