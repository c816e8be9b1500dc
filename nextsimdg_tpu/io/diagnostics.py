"""Periodic diagnostic field output.

Observability beyond the reference (whose only output is the final restart;
SURVEY.md section 5): appends time slices of selected prognostic fields to
a numpy ``.npz`` archive. Slice ``n`` is stored as the members ``time/<n>``
and ``<field>/<n>`` (native dtype), each appended to the zip archive as it
is written, so every completed slice is on disk without rewriting earlier
ones. Configured via ``model.{diagnostics_file,diagnostics_period}``.
"""

from __future__ import annotations

import zipfile
from typing import Sequence

import numpy as np

DEFAULT_FIELDS = ("hice", "cice", "hsnow", "sst", "sss")


class DiagnosticWriter:
    def __init__(
        self,
        path: str,
        field_names: Sequence[str] = DEFAULT_FIELDS,
    ) -> None:
        self.path = path
        self.field_names = tuple(field_names)
        self._n_slices = 0

    def write(self, time: float, fields) -> None:
        """Append one time slice; ``fields`` maps name -> (nx, ny) array."""
        arrays = {"time": np.float64(time)}
        arrays.update(
            (name, np.asarray(fields[name])) for name in self.field_names
        )
        # The first slice truncates whatever the path held before.
        mode = "a" if self._n_slices else "w"
        with zipfile.ZipFile(self.path, mode, allowZip64=True) as archive:
            for name, arr in arrays.items():
                member = f"{name}/{self._n_slices:08d}.npy"
                with archive.open(member, "w", force_zip64=True) as handle:
                    np.lib.format.write_array(handle, arr, allow_pickle=False)
        self._n_slices += 1

    def close(self) -> None:
        """Nothing to release: every write opens and closes the archive."""

    def __enter__(self) -> "DiagnosticWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_diagnostics(path: str):
    """Read a diagnostics file into {name: array} with 'time' included."""
    slices = {}
    with np.load(path, allow_pickle=False) as archive:
        for key in sorted(archive.files):
            name = key.rpartition("/")[0]
            slices.setdefault(name, []).append(archive[key])
    return {name: np.stack(values) for name, values in slices.items()}
