"""Benchmark harness smoke tests (tiny sizes, CPU)."""

import sys
import os

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))


def test_scaling_harness_runs_on_1_and_2_devices():
    import scaling

    devices = jax.devices()
    t1, sel1 = scaling.run_once(devices[:1], local_n=8, chunk=2)
    t2, sel2 = scaling.run_once(devices[:2], local_n=8, chunk=2)
    assert t1 > 0 and t2 > 0
    # Path-selection telemetry: every cell reports its mEVP exchange.
    assert sel1 == sel2 == {"mevp": "xla"}


def test_advection_benchmark_small():
    import run_benchmarks

    result = run_benchmarks.bench_advection(n=16, degree=1)
    assert result["value"] > 0
    assert result["unit"] == "elements/s"


def test_scaling_harness_explicit_paths():
    """The shardmap/blocked paths of the scaling harness run and report
    finite throughput on the virtual mesh; the comm-budget table orders
    blocked below per-subcycle traffic."""
    import jax
    import scaling

    budget = scaling.comm_budget(64)
    assert budget["blocked"]["messages"] < budget["shardmap"]["messages"]
    assert budget["blocked"]["bytes"] < budget["shardmap"]["bytes"]
    assert set(budget) == {"shardmap", "blocked"}

    devices = jax.devices()[:2]
    for path in ("shardmap", "blocked"):
        t, selected = scaling.run_once(devices, local_n=8, chunk=1, path=path)
        assert t > 0
        assert selected["mevp"] == ("blocked" if path == "blocked" else "xla")


def test_multihost_bench_multi_device_path_small():
    """bench_multihost_16m's n_dev>1 branch (shard_map + blocked mEVP)
    runs on the virtual 8-device mesh at a smoke size."""
    import run_benchmarks

    result = run_benchmarks.bench_multihost_16m(n=32, chunk=1)
    assert result["value"] > 0
    assert "shard_map blocked" in result["metric"]
