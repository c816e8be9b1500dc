"""chip_smoke.py: its CPU-testable parts, and the whole script on a GPU."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture
def no_gpu():
    if shutil.which("nvidia-smi") is not None:
        pytest.skip("an NVIDIA driver is present: the no-GPU checks do not apply")


@pytest.fixture
def gpu():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi not found)")


@pytest.mark.parametrize(
    "args,platforms",
    [
        ([], None),  # the parent finds no card
        (["--phase", "device"], "cuda"),  # JAX has no CUDA backend here
        (["--phase", "device"], "cpu"),  # JAX runs, but not on a GPU
    ],
)
def test_exits_nonzero_without_gpu(no_gpu, args, platforms):
    env = dict(os.environ)
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), *args],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_directory_without_the_repo_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert proc.stdout == ""


def test_result_line_format():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "x": 0}
    )
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )


@pytest.mark.parametrize(
    "argv,expected",
    [
        ([], [["device", "box", "flagship"], ["reference"]]),
        (["--four-cards"], [["four-cards"]]),
    ],
)
def test_phase_plan_and_last_line(monkeypatch, capsys, argv, expected):
    """The parent runs each phase group in one child, in order (the
    four-card option runs only its phase), and ends with the result line
    of the device the children reported."""
    calls = []
    count = 4 if argv else 1
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}

    def fake_run(cmd, env, **kwargs):
        phases = cmd[3::2]
        calls.append((phases, env))
        out = f"phase {phases[0]}: {{}}\n" + json.dumps(
            {"phases": {}, "device": device}
        )
        return types.SimpleNamespace(returncode=0, stdout=out, stderr="")

    monkeypatch.setattr(chip_smoke, "card_line", lambda: "H100, 700.00 W")
    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    assert chip_smoke.main(argv) == 0
    assert [phases for phases, _ in calls] == expected
    for phases, env in calls:
        x64 = "reference" in phases
        assert env["JAX_PLATFORMS"] == ("cuda,cpu" if x64 else "cuda")
        assert env["JAX_ENABLE_X64"] == ("1" if x64 else "0")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: H100, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": device}


def test_failed_child_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "H100, 700.00 W")
    monkeypatch.setattr(
        chip_smoke.subprocess, "run",
        lambda cmd, env, **kw: types.SimpleNamespace(
            returncode=1, stdout="phase device: {}\n", stderr="boom"
        ),
    )
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, from_env):
    from nextsimdg_tpu.utils.compile_cache import (
        DEFAULT_CACHE_DIR,
        enable_compile_cache,
    )

    before = jax.config.jax_compilation_cache_dir
    try:
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert enable_compile_cache() == str(ROOT / ".jax_cache")
            assert DEFAULT_CACHE_DIR == ROOT / ".jax_cache"
            assert jax.config.jax_compilation_cache_dir == str(ROOT / ".jax_cache")
            assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="not gpu"):
        chip_smoke.require_gpu()


def test_box_phase_small(tmp_path):
    """The box phase's CLI run and checkpoint checks at 16^2."""
    result = chip_smoke.cli_phase(
        "run/box.cfg",
        ["--dynamics.nx=16", "--dynamics.ny=16", "--dynamics.subcycles=10",
         "--model.stop=1200"],
        tmp_path / "box", types.SimpleNamespace(seconds=0.0),
    )
    assert result["steps"] == 2 and result["grid"] == "16x16"
    assert result["checkpoint_leaves"] == 12  # 7 tracer/thermo + 5 CG1 dynamics


def test_checkpoint_check_rejects_non_finite(tmp_path):
    import numpy as np

    from nextsimdg_tpu.io.coupled_restart import load_coupled_state, save_coupled_state

    chip_smoke.cli_phase(
        "run/box.cfg",
        ["--dynamics.nx=8", "--dynamics.ny=8", "--dynamics.subcycles=2",
         "--model.stop=600"],
        tmp_path, types.SimpleNamespace(seconds=0.0),
    )
    path = tmp_path / "coupled_restart.chk"
    state = load_coupled_state(str(path))
    poisoned = jax.tree.map(lambda x: x * np.nan, state)
    save_coupled_state(str(path), poisoned, time=600.0)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.check_checkpoint(path, 8, 8, 600.0)


def test_reference_phase_small():
    """f32 against f64 and the two-device f64 comparison, at 16^2 on the
    CPU (where both 'devices' are the CPU)."""
    result = chip_smoke.reference_phase(n=16, n_cpu=8, subcycles=10, steps=2)
    checks = result["errors"]
    assert set(checks) == {
        "cg1_f32_vs_f64_16", "cg1_cpu_vs_cpu_f64_8",
        "cg2_dg1_f32_vs_f64_16", "cg2_dg1_cpu_vs_cpu_f64_8",
    }
    assert checks["cg1_cpu_vs_cpu_f64_8"]["worst"] == 0.0
    assert 0.0 < checks["cg1_f32_vs_f64_16"]["worst"] < chip_smoke.TOLERANCES["f32"][1]
    assert not any(c["over"] for c in checks.values())


def test_check_errors_separates_stresses():
    errors = {".velocity.s12": 2e-2, ".velocity.u": 2e-3, ".hice": 1e-4}
    got = chip_smoke.check_errors("case", errors, "f32")
    assert got["worst_leaf"] == ".velocity.s12"
    assert got["over"] == {".velocity.u": 2e-3}
    with pytest.raises(AssertionError, match="velocity.u"):
        chip_smoke.require_within({"case": got})


def test_four_cards_phase_small(tmp_path):
    """The four-card phase at 32^2 over the 8 virtual CPU devices: single,
    GSPMD, shard_map and blocked shard_map agree leaf by leaf."""
    result = chip_smoke.four_cards_phase(
        n=32, workdir=tmp_path, clock=types.SimpleNamespace(seconds=0.0)
    )
    assert result["steps"] == 8
    assert set(result["errors"]) == {"gspmd", "shardmap", "blocked"}


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole script on the card."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=1300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


def test_device_summary_and_card_line_without_a_card(monkeypatch):
    from nextsimdg_tpu.utils import device

    assert device.device_summary() == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": jax.device_count(),
    }
    monkeypatch.setattr(device.shutil, "which", lambda name: None)
    assert device.card_name_and_power_limit() == "not available"
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        chip_smoke.card_line()
