"""Native async forcing engine tests (builds the C++ library on demand)."""

import shutil
import subprocess

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("make") is None,
    reason="no C++ toolchain",
)

from nextsimdg_tpu.io.forcing_pipeline import ForcingPipeline  # noqa: E402


def test_constant_mode_produces_requested_values():
    with ForcingPipeline.constant(
        8, 8, {"tair": -1.0, "lw_in": 311.0, "mld": 10.0}
    ) as pipe:
        for expected_step in range(3):
            fields = pipe.next_fields()
            assert fields["_step"] == expected_step
            np.testing.assert_allclose(fields["tair"], -1.0)
            np.testing.assert_allclose(fields["lw_in"], 311.0)
            np.testing.assert_allclose(fields["mld"], 10.0)


def test_cyclone_mode_vortex_moves_and_is_bounded():
    nx = ny = 32
    dx = dy = 16e3
    vmax = 30.0
    with ForcingPipeline.cyclone(
        nx, ny, dx, dy, vmax_atm=vmax, r0=100e3, period=4 * 86400.0,
        vmax_ocean=0.1, dt=6 * 3600.0,
    ) as pipe:
        f0 = pipe.next_fields()
        speeds0 = np.hypot(f0["u_atm"], f0["v_atm"])
        # Vortex winds peak near vmax and are finite everywhere.
        assert 0.5 * vmax < speeds0.max() <= 1.01 * vmax
        assert np.all(np.isfinite(speeds0))
        # The calm eye sits at the vortex center; it must move over time.
        eye0 = np.unravel_index(np.argmax(speeds0), speeds0.shape)
        for _ in range(4):
            f1 = pipe.next_fields()
        speeds1 = np.hypot(f1["u_atm"], f1["v_atm"])
        eye1 = np.unravel_index(np.argmax(speeds1), speeds1.shape)
        assert eye0 != eye1
        # Ocean gyre is steady and bounded by vmax_ocean.
        np.testing.assert_allclose(f1["u_ocean"], f0["u_ocean"])
        assert np.max(np.abs(f0["u_ocean"])) <= 0.1 + 1e-12


def test_file_mode_round_trip(tmp_path):
    from nextsimdg_tpu.io.forcing_pipeline import write_forcing_file

    path = str(tmp_path / "forcing.nxft")
    steps = [
        {"u": np.full((6, 4), float(s)), "v": np.full((6, 4), 10.0 + s)}
        for s in range(5)
    ]
    write_forcing_file(path, steps)

    with ForcingPipeline.from_file(path, ("u", "v")) as pipe:
        for s in range(5):
            fields = pipe.next_fields()
            assert fields["_step"] == s
            np.testing.assert_allclose(fields["u"], float(s))
            np.testing.assert_allclose(fields["v"], 10.0 + s)
        # Past the end (no loop): the last record repeats.
        fields = pipe.next_fields()
        np.testing.assert_allclose(fields["u"], 4.0)


def test_file_mode_loops(tmp_path):
    from nextsimdg_tpu.io.forcing_pipeline import write_forcing_file

    path = str(tmp_path / "loop.nxft")
    write_forcing_file(path, [{"a": np.full((4, 4), float(s))} for s in range(3)])
    with ForcingPipeline.from_file(path, ("a",), loop=True) as pipe:
        values = [float(pipe.next_fields()["a"][0, 0]) for _ in range(7)]
    assert values == [0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 0.0]


def test_file_mode_rejects_bad_files(tmp_path):
    import pytest as _pytest

    bad = tmp_path / "bad.nxft"
    bad.write_bytes(b"not a forcing file at all, padding padding")
    with _pytest.raises(ValueError):
        ForcingPipeline.from_file(str(bad), ("a",))


def test_producer_runs_ahead_of_consumer():
    """The engine pre-produces n_buffers steps; steps arrive in order."""
    with ForcingPipeline.constant(4, 4, {"a": 1.0}, n_buffers=4) as pipe:
        steps = [pipe.next_fields()["_step"] for _ in range(10)]
    assert steps == list(range(10))


@pytest.mark.parametrize(
    "failure,message",
    [
        (FileNotFoundError("make"), "needs make and g"),
        (
            subprocess.CalledProcessError(
                2, ["make"], output="", stderr="g++: error: boom"
            ),
            "g\\+\\+: error: boom",
        ),
    ],
)
def test_native_build_fails_loudly(monkeypatch, tmp_path, failure, message):
    """A missing toolchain or a failed compile raises with the reason."""
    import nextsimdg_tpu.io.forcing_pipeline as fp

    def broken_make(*args, **kwargs):
        raise failure

    monkeypatch.setattr(fp, "_NATIVE_DIR", str(tmp_path))
    (tmp_path / "forcing_engine.cpp").write_text("")
    monkeypatch.setattr(fp.subprocess, "run", broken_make)
    with pytest.raises(RuntimeError, match=message):
        fp._build_library()
