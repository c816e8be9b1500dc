"""Diagnostics output + coupled-state checkpoint/resume tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nextsimdg_tpu.io.coupled_restart import (
    load_coupled_state,
    load_time,
    save_coupled_state,
)
from nextsimdg_tpu.io.diagnostics import DiagnosticWriter, read_diagnostics


def test_diagnostic_writer_appends_time_slices(tmp_path):
    path = str(tmp_path / "diag.npz")
    with DiagnosticWriter(path, ("hice", "cice")) as writer:
        for step in range(3):
            writer.write(
                600.0 * step,
                {
                    "hice": np.full((4, 4), 0.1 * (step + 1)),
                    "cice": np.full((4, 4), 0.5),
                },
            )
    data = read_diagnostics(path)
    assert data["time"].tolist() == [0.0, 600.0, 1200.0]
    assert data["hice"].shape == (3, 4, 4)
    np.testing.assert_allclose(data["hice"][2], 0.3)


def test_coupled_checkpoint_roundtrip_and_resume(tmp_path):
    from tests.test_coupled import build_model

    model, state, pf, df = build_model(n=8, n_sub=10)
    state1 = model.step(state, pf, df, dt=600.0)

    path = str(tmp_path / "coupled.chk")
    save_coupled_state(path, state1, time=600.0)
    assert load_time(path) == 600.0
    restored = load_coupled_state(path, dtype=jnp.float64)
    for a, b in zip(jax.tree.leaves(state1), jax.tree.leaves(restored)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-15)

    # Resume: continuing from the checkpoint equals an uninterrupted run.
    direct = model.step(state1, pf, df, dt=600.0)
    resumed = model.step(restored, pf, df, dt=600.0)
    for a, b in zip(jax.tree.leaves(direct), jax.tree.leaves(resumed)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-14)


def test_coupled_checkpoint_roundtrip_high_order(tmp_path):
    """CG2/dG1 velocity states (HOField planes) checkpoint and resume too."""
    from nextsimdg_tpu.dynamics.mevp_ho import HOVelocityState
    from nextsimdg_tpu.modules import ModuleRegistry

    ModuleRegistry.get_loader().set_implementation(
        "Nextsim::IDynamics", "Nextsim::MEVPHighOrder"
    )
    from tests.test_coupled import build_model

    model, state, pf, df = build_model(n=8, degree=1, n_sub=10)
    state1 = model.step(state, pf, df, dt=600.0)
    assert isinstance(state1.velocity, HOVelocityState)

    path = str(tmp_path / "coupled_ho.chk")
    save_coupled_state(path, state1, time=600.0)
    restored = load_coupled_state(path, dtype=jnp.float64)
    assert isinstance(restored.velocity, HOVelocityState)
    for a, b in zip(jax.tree.leaves(state1), jax.tree.leaves(restored)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-15)

    direct = model.step(state1, pf, df, dt=600.0)
    resumed = model.step(restored, pf, df, dt=600.0)
    for a, b in zip(jax.tree.leaves(direct), jax.tree.leaves(resumed)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-14)


def test_diagnostic_writer_truncates_and_keeps_dtype(tmp_path):
    """A new writer on an existing path starts a fresh series, and f32
    fields stay f32 on disk."""
    path = str(tmp_path / "diag.npz")
    with DiagnosticWriter(path, ("hice",)) as writer:
        for step in range(2):
            writer.write(600.0 * step, {"hice": np.zeros((3, 3))})
    with DiagnosticWriter(path, ("hice",)) as writer:
        writer.write(0.0, {"hice": np.ones((3, 3), np.float32)})
    data = read_diagnostics(path)
    assert data["time"].tolist() == [0.0]
    assert data["hice"].dtype == np.float32 and data["hice"].shape == (1, 3, 3)


def test_coupled_checkpoint_keeps_its_name_and_checks_its_type(tmp_path):
    """np.savez would append '.npz' to a bare path; the checkpoint keeps
    the caller's name, and a foreign archive is refused."""
    from tests.test_coupled import build_model

    model, state, _, _ = build_model(n=8, n_sub=2)
    path = tmp_path / "coupled.chk"
    save_coupled_state(str(path), state, time=0.0)
    assert path.exists() and not (tmp_path / "coupled.chk.npz").exists()

    foreign = tmp_path / "other.chk"
    with open(foreign, "wb") as handle:
        np.savez(handle, **{"structure/type": np.array("devgrid")})
    with pytest.raises(ValueError, match="not a coupled_dg checkpoint"):
        load_coupled_state(str(foreign))


def _read_restart(path):
    from nextsimdg_tpu.io.restart import read_restart

    read_restart(path)


def _forcing_provider(path):
    from nextsimdg_tpu.io.forcing_file import ForcingProvider

    ForcingProvider(path)


def _era5(path):
    from nextsimdg_tpu.io.era5 import ERA5Dataset

    ERA5Dataset(path)



@pytest.mark.parametrize("reader", [_read_restart, _forcing_provider, _era5])
def test_hdf5_readers_name_the_missing_package(monkeypatch, tmp_path, reader):
    """h5py is optional: the readers that need it import it on first use
    and, without it, say which package is missing."""
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        reader(str(tmp_path / "missing.nc"))
