"""Headline benchmark: mesh-element updates/s for DG advection + mEVP.

The wind-driven box configuration on a 256x256 mesh, dG1 tracers, 100 mEVP
subcycles per step, f32, on JAX's default device. One JSON line is
printed, naming the device it ran on:

    {"metric": ..., "value": N, "unit": "elements/s", "platform": ...,
     "device_kind": ..., "power_limit": ...}
"""

from __future__ import annotations

import json
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from nextsimdg_tpu.coupled import CoupledModel
    from nextsimdg_tpu.dynamics import MEVPParams, RectMesh
    from nextsimdg_tpu.dynamics.mevp import DynamicsForcing
    from nextsimdg_tpu.state import Forcing
    from nextsimdg_tpu.utils.compile_cache import enable_compile_cache
    from nextsimdg_tpu.utils.device import card_name_and_power_limit

    enable_compile_cache()
    n = 256
    n_subcycles = 100
    dt = 600.0
    dtype = jnp.float32

    mesh = RectMesh(nx=n, ny=n, dx=512e3 / n, dy=512e3 / n)
    model = CoupledModel(mesh, degree=1, mevp_params=MEVPParams(), n_subcycles=n_subcycles)
    state = model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0, dtype=dtype
    )
    # Wind 8 m/s (the BASELINE config-3 strong-drift box). CFL-adaptive
    # transport substepping (the default) raises the substep count when
    # the drift is fast, so this config runs indefinitely; fast-drift
    # steps advect twice at dt/2, which is part of the measured cost.
    # Every timed run restarts from the initial state (identical work).
    full = lambda v: jnp.full((n, n), v, dtype=dtype)
    phys_forcing = Forcing(
        tair=full(-10.0), dew2m=full(-12.0), pair=full(1e5), sw_in=full(10.0),
        lw_in=full(250.0), mld=full(10.0), snowfall=full(1e-4), wind=full(8.0),
    )
    dyn_forcing = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )

    # Dynamics-only (BASELINE config 3: thermodynamics off) via lax.scan,
    # compiled once and warmed up before it is timed.
    chunk = 256

    def run(s):
        return jax.block_until_ready(
            model.run(s, phys_forcing, dyn_forcing, dt, chunk, do_thermo=False)
        )

    run(state)  # compile + warmup
    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        out = run(state)
        best = min(best, time.perf_counter() - t0)
    if not np.all(np.isfinite(np.asarray(out.hice))):
        raise RuntimeError("benchmark state went non-finite")

    device = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "element updates/s (dG1 advection + 100-subcycle mEVP, 256x256, f32)",
                "value": float(f"{n * n * chunk / best:.4g}"),
                "unit": "elements/s",
                "platform": device.platform,
                "device_kind": device.device_kind,
                "power_limit": card_name_and_power_limit(),
            }
        )
    )


if __name__ == "__main__":
    main()
