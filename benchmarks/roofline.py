"""Per-subcycle operation census of the mEVP solvers.

Counts, from the solvers' own jaxprs, the per-element work of one
subcycle, classed as

* ``cheap``  — add/sub/mul/select/compare/min/max/abs/neg;
* ``costly`` — div/sqrt/rsqrt/exp (reported separately, NOT folded into
  the cheap count);
* ``shift planes`` — whole-plane slice+concat neighbor shifts (no flops,
  but each one moves a plane).

This is the operation half of a roofline; the device's measured time per
subcycle comes from a profiler trace on the card. Usage::

    python benchmarks/roofline.py
"""

from __future__ import annotations

import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

CHEAP = {
    "add", "sub", "mul", "max", "min", "select_n", "ge", "gt", "le", "lt",
    "eq", "ne", "abs", "neg", "sign", "and", "or", "not", "xor",
    "integer_pow",  # x**2 lowers to one multiply
}
COSTLY = {"div", "sqrt", "rsqrt", "exp", "log", "hypot", "pow"}
SHIFT = {"concatenate"}  # slice+concat pairs = the neighbor shifts
IGNORE = {
    "slice", "broadcast_in_dim", "convert_element_type", "reshape",
    "squeeze", "iota", "copy", "transpose", "pjit", "closed_call",
    "custom_jvp_call", "custom_vjp_call", "stop_gradient",
}


def _census(fn, args, n_elements):
    """Count per-element work in fn's jaxpr, normalized per element."""
    import jax

    jaxpr = jax.make_jaxpr(fn)(*args)
    counts = Counter()

    def walk(jx):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            sub = [v for k, v in eqn.params.items() if k in ("jaxpr", "call_jaxpr")]
            if sub:
                for s in sub:
                    walk(s.jaxpr if hasattr(s, "jaxpr") else s)
                continue
            out_sz = sum(int(np.prod(v.aval.shape)) for v in eqn.outvars)
            if name in CHEAP:
                counts["cheap"] += out_sz
            elif name in COSTLY:
                counts["costly"] += out_sz
                counts[f"costly:{name}"] += out_sz
            elif name in SHIFT:
                counts["shift"] += out_sz
                # Which plane axis the neighbor move crosses: the last
                # (contiguous) dim or the one before it.
                ndim = len(eqn.outvars[0].aval.shape)
                axis = eqn.params.get("dimension", ndim - 1)
                which = "axis1" if axis == ndim - 1 else "axis0"
                counts[f"shift:{which}"] += out_sz
            elif name not in IGNORE:
                counts[f"other:{name}"] += out_sz

    walk(jaxpr.jaxpr)
    return {k: v / n_elements for k, v in counts.items()}


def census_cg1(n=256):
    import jax.numpy as jnp

    from nextsimdg_tpu.dynamics.mesh import RectMesh
    from nextsimdg_tpu.dynamics.mevp import (
        DynamicsForcing, MEVPParams, MEVPSolver, VelocityState,
    )

    mesh = RectMesh(nx=n, ny=n, dx=4e3, dy=4e3)
    solver = MEVPSolver(mesh, MEVPParams(), backend="xla")
    dtype = jnp.float32
    full = lambda v: jnp.full((n, n), v, dtype)
    state = VelocityState.zeros(n, n, dtype)
    df = DynamicsForcing(u_atm=full(6.0), v_atm=full(2.0),
                         u_ocean=full(0.02), v_ocean=full(0.0))
    # Abstract shapes only — no device dispatch.
    import jax

    consts = jax.eval_shape(
        lambda s, h, a, d, m: solver.step_consts(s, h, a, d, m, 600.0),
        state, full(1.2), full(0.95), df, solver.boundary_mask(dtype),
    )
    carry = jax.eval_shape(
        lambda s: (s.u, s.v, s.s11, s.s22, s.s12), state
    )
    return _census(
        lambda c, k: solver.subcycle_body(c, k, 600.0), (carry, consts), n * n
    )


def census_ho(n=128):
    import jax.numpy as jnp

    from nextsimdg_tpu.dynamics.mesh import RectMesh
    from nextsimdg_tpu.dynamics.mevp import MEVPParams
    from nextsimdg_tpu.dynamics.mevp_ho import (
        HODynamicsForcing, HOField, HOVelocityState, MEVPSolverHO,
    )

    mesh = RectMesh(nx=n, ny=n, dx=4e3, dy=4e3)
    solver = MEVPSolverHO(mesh, MEVPParams(), backend="xla")
    dtype = jnp.float32
    full = lambda v: jnp.full((n, n), v, dtype)
    const = lambda v: HOField(v=full(v), b=full(v), l=full(v), c=full(v))
    state = HOVelocityState.zeros(n, n, dtype)
    df = HODynamicsForcing(u_atm=const(6.0), v_atm=const(2.0),
                           u_ocean=const(0.02), v_ocean=const(0.0))
    # Abstract shapes only — no device dispatch.
    import jax

    consts = jax.eval_shape(
        lambda s, h, a, d, m: solver.step_consts(s, h, a, d, m, 600.0),
        state, full(1.2), full(0.95), df, solver.boundary_mask(dtype),
    )
    carry = jax.eval_shape(
        lambda s: (s.u, s.v, s.s11, s.s22, s.s12), state
    )
    return _census(
        lambda c, k: solver.subcycle_body(c, k, 600.0), (carry, consts), n * n
    )


def main():
    from nextsimdg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cg1 = census_cg1()
    ho = census_ho()
    result = {
        "census_cg1_per_element_subcycle": {
            k: round(v, 2) for k, v in sorted(cg1.items())
        },
        "census_ho_per_element_subcycle": {
            k: round(v, 2) for k, v in sorted(ho.items())
        },
    }
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
