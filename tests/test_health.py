"""Failure detection + elastic recovery (runtime/health.py).

The reference has no failure detection (SURVEY §5; the only resilience
is Model.cpp:40-53's best-effort restart write) — these tests cover the
production-side machinery this framework adds on top.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from nextsimdg_tpu.runtime.health import (
    HealthMonitor,
    NonFiniteStateError,
    finite_probe,
)


@dataclasses.dataclass
class ToyState:
    a: jnp.ndarray
    b: jnp.ndarray


import jax

jax.tree_util.register_pytree_node(
    ToyState,
    lambda s: ((s.a, s.b), None),
    lambda _, c: ToyState(*c),
)


def make_state(bad=False):
    a = jnp.ones((4, 4))
    b = jnp.zeros((4, 4))
    if bad:
        b = b.at[2, 2].set(jnp.nan)
    return ToyState(a, b)


def test_finite_probe_detects_nan_and_inf():
    assert finite_probe(make_state())
    assert not finite_probe(make_state(bad=True))
    inf_state = ToyState(jnp.ones(3).at[0].set(jnp.inf), jnp.zeros(3))
    assert not finite_probe(inf_state)
    # Non-array leaves (e.g. static metadata) are ignored, empty is fine.
    assert finite_probe({"meta": "name", "x": jnp.ones(2)})
    assert finite_probe({})


def test_monitor_records_good_and_probes_on_period():
    mon = HealthMonitor(period=2, mode="abort")
    mon.record_good(0, 0.0, make_state())
    assert mon.after_step(1, 600.0, make_state()) == "ok"  # not due
    assert not mon.due(1)
    assert mon.due(2)
    assert mon.after_step(2, 1200.0, make_state()) == "ok"
    assert mon.last_good[0] == 2


def test_monitor_abort_mode_raises_with_last_good():
    mon = HealthMonitor(period=1, mode="abort")
    mon.record_good(0, 0.0, make_state())
    mon.after_step(1, 600.0, make_state())
    with pytest.raises(NonFiniteStateError) as err:
        mon.after_step(2, 1200.0, make_state(bad=True))
    assert err.value.step == 2
    assert err.value.last_good[0] == 1
    assert finite_probe(err.value.last_good[2])


def test_monitor_retry_halved_schedules_replay_then_recovers():
    mon = HealthMonitor(period=2, mode="retry-halved")
    good = make_state()
    mon.record_good(0, 0.0, good)
    assert mon.after_step(1, 600.0, good) == "ok"
    assert mon.after_step(2, 1200.0, make_state(bad=True)) == "rollback"
    step, t, state = mon.rollback_target()
    assert (step, t) == (0, 0.0)
    assert state is good
    # Replay the 2-step segment as 4 half-steps; healthy at segment end.
    assert mon.recovering
    assert mon.after_step(0, 300.0, good) == "ok"
    assert mon.after_step(0, 600.0, good) == "ok"
    assert mon.after_step(1, 900.0, good) == "ok"
    assert mon.recovering
    assert mon.after_step(2, 1200.0, good) == "ok"  # segment-end probe
    assert not mon.recovering
    assert mon.last_good[0] == 2
    # The retry re-arms after a successful recovery: a later failure
    # rolls back again instead of aborting.
    assert mon.after_step(4, 2400.0, make_state(bad=True)) == "rollback"


def test_monitor_retry_halved_aborts_when_replay_fails_too():
    mon = HealthMonitor(period=1, mode="retry-halved")
    mon.record_good(0, 0.0, make_state())
    assert mon.after_step(1, 600.0, make_state(bad=True)) == "rollback"
    assert mon.after_step(0, 300.0, make_state(bad=True)) == "ok"  # mid-segment
    with pytest.raises(NonFiniteStateError):
        mon.after_step(1, 600.0, make_state(bad=True))  # segment-end probe


def test_monitor_disabled_when_period_zero():
    mon = HealthMonitor(period=0)
    # Never probes, never raises — even on a poisoned state.
    assert mon.after_step(5, 0.0, make_state(bad=True)) == "ok"
    assert not mon.due(5)


def test_monitor_rejects_unknown_mode():
    with pytest.raises(ValueError):
        HealthMonitor(period=1, mode="carry-on")


def test_finite_probe_is_cheap_scalar_fetch():
    """The probe reduces on device; only a bool crosses to the host."""
    big = ToyState(jnp.ones((256, 256)), jnp.ones((256, 256)))
    out = finite_probe(big)
    assert isinstance(out, bool) and out
    assert not finite_probe(
        ToyState(big.a, big.b.at[100, 200].set(np.inf))
    )


def test_health_abort_in_shardmap_mode(tmp_path, monkeypatch):
    """The probe runs jitted over the sharded global state (the
    multi-device situation: shards live on 8 mesh devices) and the post-mortem path
    still writes one global checkpoint."""
    import os

    import nextsimdg_tpu.parallel.shardmap as sm
    from nextsimdg_tpu.io.coupled_restart import load_coupled_state, load_time
    from nextsimdg_tpu.runtime.coupled_main import run_coupled
    from tests.test_coupled_main import write_cfg

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual mesh")

    monkeypatch.chdir(tmp_path)
    cfg = write_cfg(
        tmp_path,
        extra=(
            "[parallel]\nmode = shardmap\nmesh_shape = 4x2\n"
            "mevp_backend = blocked\nmevp_block_halo = 4\n"
        ),
    )
    cfg2 = tmp_path / "health.cfg"
    cfg2.write_text("[model]\nhealth_period = 1\n")

    orig_build = sm.build_sharded_coupled_model
    calls = {"n": 0}

    def poisoned_build(*a, **k):
        model, step = orig_build(*a, **k)

        def wrapped(state, pf, df, dt, **kw):
            out = step(state, pf, df, dt, **kw)
            calls["n"] += 1
            if calls["n"] == 2:
                out = dataclasses.replace(out, hice=out.hice * jnp.nan)
            return out

        return model, wrapped

    monkeypatch.setattr(sm, "build_sharded_coupled_model", poisoned_build)
    with pytest.raises(NonFiniteStateError):
        run_coupled(["prog", "--config-file", cfg, "--config-file", str(cfg2)])

    assert os.path.exists("coupled_failed.post_mortem.chk")
    good = load_coupled_state("coupled_restart.chk")
    assert good.hice.shape == (3, 16, 16)  # full GLOBAL arrays, one file
    assert np.all(np.isfinite(np.asarray(good.hice)))
    assert load_time("coupled_restart.chk") == 600.0
