"""Checkpoint/resume for the full coupled model state.

The reference restart schema carries only the thermodynamic prognostics;
the coupled dynamical model additionally needs the DG tracer moments, the
CG velocity and the element stresses (mEVP is a pseudo-time iteration whose
warm start matters). The file is a numpy ``.npz`` archive of structure
type ``"coupled_dg"``: 0-d members ``structure/{type, dg_dofs, nlayers,
time, velocity_type}`` plus one ``state/<leaf>`` array per pytree leaf, in
the state's native dtype.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..coupled import CoupledState
from ..dynamics.mevp import VelocityState

STRUCTURE_TYPE = "coupled_dg"

_SCALAR_LEAVES = ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice")

#: velocity pytree schema per dynamics discretization.
_VELOCITY_LEAVES = {
    "cg1": (
        "velocity/u", "velocity/v",
        "velocity/s11", "velocity/s22", "velocity/s12",
    ),
    "cg2_dg1": tuple(
        f"velocity/{comp}/{plane}" for comp in ("u", "v") for plane in "vblc"
    ) + ("velocity/s11", "velocity/s22", "velocity/s12"),
}


def _get(state: CoupledState, path: str):
    obj = state
    for part in path.split("/"):
        obj = getattr(obj, part)
    return obj


def _velocity_type(velocity) -> str:
    from ..dynamics.mevp_ho import HOVelocityState

    return "cg2_dg1" if isinstance(velocity, HOVelocityState) else "cg1"


def save_coupled_state(path: str, state: CoupledState, time: float = 0.0) -> None:
    import jax

    from ..state import fetch_state

    # Multi-host: fetch_state is a COLLECTIVE (process_allgather of every
    # leaf), so all processes call it — but exactly one writes the file
    # (shared filesystems would otherwise race N writers on one path).
    state = fetch_state(state)  # batched, alias-free device->host transfer
    if jax.process_index() != 0:
        return
    vel_type = _velocity_type(state.velocity)
    members = {
        "structure/type": np.array(STRUCTURE_TYPE),
        "structure/dg_dofs": np.int64(state.n_dg_dofs),
        "structure/nlayers": np.int64(state.tice.shape[0]),
        "structure/time": np.float64(time),
        "structure/velocity_type": np.array(vel_type),
    }
    for leaf in _SCALAR_LEAVES + _VELOCITY_LEAVES[vel_type]:
        # Native dtype: upcasting f32 production state to f64 would double
        # checkpoint size and write time. Round-trip stays bit-exact either
        # way — loads convert to the requested dtype, and f64 runs still
        # store f64 (the reference-schema f8 contract lives in io/restart,
        # not here).
        members[f"state/{leaf}"] = np.asarray(_get(state, leaf))
    # An open file keeps the caller's name (np.savez appends ".npz" to a
    # path that lacks it).
    with open(path, "wb") as handle:
        np.savez(handle, **members)


def _read_structure(archive, key: str) -> str:
    return str(archive[f"structure/{key}"])


def load_coupled_state(path: str, dtype=jnp.float32) -> CoupledState:
    with np.load(path, allow_pickle=False) as archive:
        stype = _read_structure(archive, "type")
        if stype != STRUCTURE_TYPE:
            raise ValueError(f"not a coupled_dg checkpoint: {stype}")
        vel_type = _read_structure(archive, "velocity_type")
        data = {
            leaf: jnp.asarray(archive[f"state/{leaf}"], dtype=dtype)
            for leaf in _SCALAR_LEAVES + _VELOCITY_LEAVES[vel_type]
        }
    if vel_type == "cg2_dg1":
        from ..dynamics.mevp_ho import HOField, HOVelocityState

        field = lambda comp: HOField(
            **{plane: data[f"velocity/{comp}/{plane}"] for plane in "vblc"}
        )
        velocity = HOVelocityState(
            u=field("u"), v=field("v"),
            s11=data["velocity/s11"], s22=data["velocity/s22"],
            s12=data["velocity/s12"],
        )
    else:
        velocity = VelocityState(
            u=data["velocity/u"], v=data["velocity/v"],
            s11=data["velocity/s11"], s22=data["velocity/s22"],
            s12=data["velocity/s12"],
        )
    return CoupledState(
        hice=data["hice"], cice=data["cice"], hsnow=data["hsnow"],
        sst=data["sst"], sss=data["sss"], tice=data["tice"],
        velocity=velocity, new_ice=data["new_ice"],
    )


def load_time(path: str) -> float:
    with np.load(path, allow_pickle=False) as archive:
        return float(archive["structure/time"])
