"""Large-grid CG1 mEVP timing: one outer step of 100 subcycles.

Times a scan of outer steps around a single dispatch, ending in
``jax.block_until_ready``. Usage:

    python benchmarks/mevp_large.py [n ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from nextsimdg_tpu.dynamics import MEVPParams, RectMesh
from nextsimdg_tpu.dynamics.mevp import DynamicsForcing, MEVPSolver, VelocityState
from nextsimdg_tpu.utils.compile_cache import enable_compile_cache


def bench(n, n_sub=100, outer=None, reps=3):
    outer = outer or max(1, 2_000_000_000 // (n * n * n_sub))
    mesh = RectMesh(nx=n, ny=n, dx=4e6 / n, dy=4e6 / n)
    solver = MEVPSolver(mesh, MEVPParams())
    dtype = jnp.float32
    full = lambda v: jnp.full((n, n), v, dtype)
    state = VelocityState.zeros(n, n, dtype)
    df = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    mask = solver.boundary_mask(dtype=dtype)
    h, a = full(1.0), full(0.9)

    @jax.jit
    def run(st):
        def body(s, _):
            return solver.step(s, h, a, df, mask, 600.0, n_sub), None

        out, _ = jax.lax.scan(body, st, None, length=outer)
        return out

    st = jax.block_until_ready(run(state))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        st = jax.block_until_ready(run(st))
        best = min(best, (time.perf_counter() - t0) / outer)
    device = jax.devices()[0]
    print(
        f"n={n} on {device.platform}/{device.device_kind}: "
        f"{best*1e3:.1f} ms / {n_sub} subcycles "
        f"({n*n*n_sub/best/1e9:.2f}G subcycle-elements/s, outer={outer})"
    )
    return best


if __name__ == "__main__":
    enable_compile_cache()
    sizes = [int(a) for a in sys.argv[1:]] or [1024, 2048, 4096]
    for n in sizes:
        bench(n)
