"""The optional h5py dependency.

Only the HDF5/netCDF readers and writers need h5py: the reference-schema
restart (``io.restart``), forcing archives and ERA5 files. The coupled
model's own checkpoint and diagnostics are numpy archives, so the coupled
CLI runs where h5py is not installed.
"""

from __future__ import annotations


def require_h5py():
    """Import h5py on first use, naming the missing package if it fails."""
    try:
        import h5py
    except ModuleNotFoundError as err:
        raise ModuleNotFoundError(
            "the h5py package is required to read or write HDF5/netCDF files "
            "(reference restarts, forcing archives, ERA5 input)"
        ) from err
    return h5py
