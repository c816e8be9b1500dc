"""Python binding for the native asynchronous forcing engine.

Wraps ``native/forcing_engine.cpp`` (built on demand with g++) via ctypes:
a background C++ thread fills a ring of buffers with per-step forcing
fields, so forcing generation/IO overlaps with device compute. See the
.cpp header comment for modes and buffer layout.

Usage::

    pipe = ForcingPipeline.cyclone(nx, ny, dx, dy, vmax_atm=30.0, ...)
    for _ in range(n_steps):
        fields = pipe.next_fields()       # dict of (nx, ny) float64 arrays
        ...feed to the device...
    pipe.close()
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_NAME = "libforcing_engine.so"

#: mode-1 field order (matches forcing_engine.cpp fill()).
CYCLONE_FIELDS = ("u_atm", "v_atm", "u_ocean", "v_ocean")


def _build_library() -> str:
    """Compile the shared library if missing or stale; return its path."""
    native_dir = os.path.abspath(_NATIVE_DIR)
    lib_path = os.path.join(native_dir, _LIB_NAME)
    src_path = os.path.join(native_dir, "forcing_engine.cpp")
    if (
        not os.path.exists(lib_path)
        or os.path.getmtime(lib_path) < os.path.getmtime(src_path)
    ):
        try:
            subprocess.run(
                ["make", "-C", native_dir], check=True, capture_output=True,
                text=True,
            )
        except FileNotFoundError as err:
            raise RuntimeError(
                f"building {_LIB_NAME} needs make and g++: {err}"
            ) from err
        except subprocess.CalledProcessError as err:
            raise RuntimeError(
                f"building {_LIB_NAME} failed:\n{err.stdout}{err.stderr}"
            ) from err
    return lib_path


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_library())
        lib.fe_create.restype = ctypes.c_void_p
        lib.fe_create.argtypes = [ctypes.c_int64] * 4
        lib.fe_start_constant.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.fe_start_cyclone.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 9
        lib.fe_start_file.restype = ctypes.c_int
        lib.fe_start_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.fe_acquire.restype = ctypes.c_int
        lib.fe_acquire.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fe_release.argtypes = [ctypes.c_void_p]
        lib.fe_stop.argtypes = [ctypes.c_void_p]
        lib.fe_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class ForcingPipeline:
    def __init__(self, nx: int, ny: int, field_names, n_buffers: int = 3) -> None:
        self._lib = _load()
        self._nx, self._ny = nx, ny
        self._field_names = tuple(field_names)
        self._handle = self._lib.fe_create(nx, ny, len(self._field_names), n_buffers)
        self._open = True
        self._held = False

    # -- constructors --------------------------------------------------------
    @classmethod
    def constant(cls, nx: int, ny: int, values: Dict[str, float], n_buffers: int = 3):
        pipe = cls(nx, ny, list(values), n_buffers)
        arr = (ctypes.c_double * len(values))(*values.values())
        pipe._lib.fe_start_constant(pipe._handle, arr)
        return pipe

    @classmethod
    def cyclone(
        cls, nx: int, ny: int, dx: float, dy: float, *,
        vmax_atm: float = 30.0, r0: float = 100e3, period: float = 4 * 86400.0,
        vmax_ocean: float = 0.1, dt: float = 600.0, n_buffers: int = 3,
    ):
        """The standard moving-cyclone benchmark forcing (CG node fields)."""
        pipe = cls(nx, ny, CYCLONE_FIELDS, n_buffers)
        pipe._lib.fe_start_cyclone(
            pipe._handle, dx, dy, nx * dx, ny * dy,
            vmax_atm, r0, period, vmax_ocean, dt,
        )
        return pipe

    @classmethod
    def from_file(cls, path: str, field_names, loop: bool = False, n_buffers: int = 3):
        """Stream per-step forcing records from a binary NXFT file.

        See :func:`write_forcing_file` for the format; the producer thread
        reads ahead of the model (prefetch = n_buffers records).
        """
        nx, ny, n_fields, _ = read_forcing_file_header(path)
        if n_fields != len(tuple(field_names)):
            raise ValueError(
                f"file has {n_fields} fields, caller named {len(tuple(field_names))}"
            )
        pipe = cls(nx, ny, field_names, n_buffers)
        rc = pipe._lib.fe_start_file(pipe._handle, path.encode(), int(loop))
        if rc != 0:
            raise ValueError(f"bad forcing file {path!r} (code {rc})")
        return pipe

    # -- consumption ---------------------------------------------------------
    def next_fields(self) -> Dict[str, np.ndarray]:
        """Block until the next step's fields are ready; return copies.

        The engine's internal buffer is recycled immediately after the copy,
        keeping the producer `n_buffers` steps ahead.
        """
        if self._held:
            self._lib.fe_release(self._handle)
            self._held = False
        data = ctypes.POINTER(ctypes.c_double)()
        step = ctypes.c_int64()
        ok = self._lib.fe_acquire(self._handle, ctypes.byref(data), ctypes.byref(step))
        if not ok:
            raise RuntimeError("forcing engine stopped")
        plane = self._nx * self._ny
        n = len(self._field_names)
        raw = np.ctypeslib.as_array(data, shape=(n * plane,))
        self._held = True
        out = {}
        for f, name in enumerate(self._field_names):
            out[name] = raw[f * plane : (f + 1) * plane].reshape(self._nx, self._ny).copy()
        out["_step"] = int(step.value)
        return out

    def close(self) -> None:
        if self._open:
            self._lib.fe_stop(self._handle)
            self._lib.fe_destroy(self._handle)
            self._open = False

    def __enter__(self) -> "ForcingPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


_NXFT_MAGIC = 0x4E584654


def write_forcing_file(path: str, steps) -> None:
    """Write a binary NXFT forcing file.

    ``steps``: sequence of per-step dicts/sequences of (nx, ny) float64
    arrays; all steps must share shapes and field count. Format: 5 int64
    header (magic 'NXFT', nx, ny, n_fields, n_steps) + sequential planes.
    """
    steps = list(steps)
    first = steps[0]
    arrays0 = list(first.values()) if isinstance(first, dict) else list(first)
    nx, ny = arrays0[0].shape
    n_fields = len(arrays0)
    with open(path, "wb") as handle:
        np.asarray(
            [_NXFT_MAGIC, nx, ny, n_fields, len(steps)], dtype=np.int64
        ).tofile(handle)
        for step in steps:
            arrays = list(step.values()) if isinstance(step, dict) else list(step)
            for arr in arrays:
                np.asarray(arr, dtype=np.float64).reshape(nx, ny).tofile(handle)


def read_forcing_file_header(path: str):
    """Return (nx, ny, n_fields, n_steps) of an NXFT file."""
    header = np.fromfile(path, dtype=np.int64, count=5)
    if len(header) != 5 or header[0] != _NXFT_MAGIC:
        raise ValueError(f"not an NXFT forcing file: {path!r}")
    return int(header[1]), int(header[2]), int(header[3]), int(header[4])
