"""Time-dependent forcing from files.

The reference stubs external data entirely ("TODO Real external data
handling", ``core/src/Model.cpp:75-76``; constant ``DummyExternalData``).
This module supplies the real thing: an HDF5 forcing archive with a time
axis and per-field (time, nx, ny) series, read into a provider that
linearly interpolates in time (optionally periodic, climatology-style) and
returns the model's forcing pytrees.

Schema (HDF5): group ``forcing`` with dataset ``time`` (seconds, ascending)
and any subset of the field names in THERMO_FIELDS / DYNAMICS_FIELDS, each
(T, nx, ny) float; missing thermo fields fall back to the reference's dummy
constants.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from ..state import Forcing
from .hdf5 import require_h5py

THERMO_FIELDS = ("tair", "dew2m", "pair", "sw_in", "lw_in", "mld", "snowfall", "wind")
DYNAMICS_FIELDS = ("u_atm", "v_atm", "u_ocean", "v_ocean")

#: Reference dummy values (DummyExternalData.hpp:22-34) as fallbacks.
DUMMY_VALUES = {
    "tair": -1.0, "dew2m": -4.0, "pair": 1e5, "sw_in": 0.0, "lw_in": 311.0,
    "mld": 10.0, "snowfall": 0.0, "wind": 0.0,
    "u_atm": 0.0, "v_atm": 0.0, "u_ocean": 0.0, "v_ocean": 0.0,
}


def write_forcing_archive(path: str, time, fields: Dict[str, np.ndarray]) -> None:
    """Write a forcing archive: time (T,), each field (T, nx, ny)."""
    time = np.asarray(time, dtype=np.float64)
    with require_h5py().File(path, "w") as handle:
        group = handle.create_group("forcing")
        group.create_dataset("time", data=time)
        for name, series in fields.items():
            series = np.asarray(series, dtype=np.float64)
            if series.shape[0] != time.shape[0]:
                raise ValueError(f"field {name!r} has {series.shape[0]} steps, time has {time.shape[0]}")
            group.create_dataset(name, data=series)


class ForcingProvider:
    """Linear-in-time interpolation of a forcing archive.

    ``periodic=True`` wraps the time axis (climatology); otherwise times are
    clamped to the archive's range.
    """

    def __init__(self, path: str, periodic: bool = False, dtype=jnp.float32) -> None:
        self.dtype = dtype
        self.periodic = periodic
        with require_h5py().File(path, "r") as handle:
            group = handle["forcing"]
            self.time = np.asarray(group["time"], dtype=np.float64)
            self.fields = {
                name: np.asarray(group[name])
                for name in group
                if name != "time"
            }
        if len(self.time) < 1:
            raise ValueError("forcing archive has no time steps")
        shapes = {f.shape[1:] for f in self.fields.values()}
        if len(shapes) > 1:
            raise ValueError(f"inconsistent field shapes: {shapes}")
        self.shape = shapes.pop() if shapes else None
        self.t0 = float(self.time[0])
        self.t1 = float(self.time[-1])

    def _interp(self, name: str, t: float, nx: int, ny: int):
        series = self.fields.get(name)
        if series is None:
            return np.full((nx, ny), DUMMY_VALUES[name])
        if self.periodic and self.t1 > self.t0:
            t = self.t0 + (t - self.t0) % (self.t1 - self.t0)
        t = min(max(t, self.t0), self.t1)
        idx = int(np.searchsorted(self.time, t, side="right") - 1)
        idx = min(max(idx, 0), len(self.time) - 1)
        if idx == len(self.time) - 1:
            return series[idx]
        span = self.time[idx + 1] - self.time[idx]
        w = (t - self.time[idx]) / span if span > 0 else 0.0
        return (1.0 - w) * series[idx] + w * series[idx + 1]

    def thermo_forcing(self, t: float, nx: int, ny: int) -> Forcing:
        values = {
            name: jnp.asarray(
                np.broadcast_to(self._interp(name, t, nx, ny), (nx, ny)),
                dtype=self.dtype,
            )
            for name in THERMO_FIELDS
        }
        return Forcing(**values)

    def dynamics_forcing(self, t: float, nx: int, ny: int):
        from ..dynamics.mevp import DynamicsForcing

        values = {
            name: jnp.asarray(
                np.broadcast_to(self._interp(name, t, nx, ny), (nx, ny)),
                dtype=self.dtype,
            )
            for name in DYNAMICS_FIELDS
        }
        return DynamicsForcing(**values)
