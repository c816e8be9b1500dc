"""Real multi-process validation on the CPU backend.

These tests spawn ACTUAL separate Python processes, wire them into one
JAX runtime via ``jax.distributed.initialize`` (coordinator on
localhost), build a device mesh spanning every process, run the coupled
model on it, and compare the gathered global result against an
uninterrupted single-device run. This exercises process-spanning
collectives, ``jax.make_array_from_callback`` global-array assembly, and
the multi-host launch path — none of which the in-process 8-device mesh
touches (SURVEY.md §2.3/§5: multi-host orchestration).
"""

import pytest

from nextsimdg_tpu.parallel.multiprocess import launch


def _launch_or_skip(num_processes, **kwargs):
    try:
        return launch(num_processes, **kwargs)
    except RuntimeError as err:
        msg = str(err)
        # Environments without working localhost gRPC coordination can't
        # run the multi-process leg at all; anything else — INCLUDING a
        # timeout, which is how a deadlocked cross-process collective
        # presents — is a real failure and must not skip.
        if "initialize" in msg or "coordinator" in msg:
            pytest.skip(f"multi-process runtime unavailable: {msg[:200]}")
        raise


@pytest.mark.slow
def test_two_process_run_matches_single_device():
    """2 processes x 2 devices: gspmd, blocked shard_map, AND the
    config-5 composition (spherical 360-degree ring + LocalMeshView +
    blocked — the wrap ppermute crosses PROCESS boundaries)."""
    paths = ("gspmd", "blocked", "blocked-ring")
    results = _launch_or_skip(
        2, devices_per_process=2, paths=paths,
        n=16, steps=2, n_subcycles=10,
    )
    assert len(results) == 2
    for r in results:
        assert r["ok"], r
        assert r["process_count"] == 2
        assert r["global_devices"] == 4
        for path in paths:
            # The jitted health probe ran on the process-spanning global
            # state in-worker (the multi-host case): healthy detected healthy,
            # a poisoned copy detected non-finite.
            assert r["paths"][path]["finite_probe"] is True
            assert r["paths"][path]["finite_probe_detects"] is True
            # assert_allclose already ran in-worker; the reported error is
            # in tolerance units (<= 1.0 means within rtol/atol budget).
            assert r["paths"][path]["error_in_tolerance_units"] <= 1.0
        # Multi-host checkpointing: collectively gathered, written once
        # by process 0, round-tripped bit-exactly (asserted in-worker).
        assert "checkpoint" in r["paths"]["gspmd"]


@pytest.mark.slow
def test_four_process_run_matches_single_device():
    """4 processes x 2 devices = 8 global devices, explicit blocked halos."""
    results = _launch_or_skip(
        4, devices_per_process=2, paths=("blocked",),
        n=16, steps=2, n_subcycles=10,
    )
    assert len(results) == 4
    for r in results:
        assert r["ok"], r
        assert r["process_count"] == 4
        assert r["global_devices"] == 8
        assert r["paths"]["blocked"]["error_in_tolerance_units"] <= 1.0
