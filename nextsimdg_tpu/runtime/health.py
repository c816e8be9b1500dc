"""Failure detection and elastic recovery for long production runs.

The reference has NO failure detection (SURVEY §5): its only resilience
feature is the Model destructor's best-effort restart write with a
swallow-all catch (core/src/Model.cpp:40-53).  At production scale (16M
elements, multi-day runs through a device mesh) a non-finite blowup that
is only discovered when the final checkpoint is read wastes the whole
run.  This module supplies the production-side machinery:

* ``finite_probe(state)`` — ONE fused on-device all-finite reduction over
  every leaf of the state pytree, fetched as a single scalar.  Under
  GSPMD/shard_map the reduction runs sharded and only the bool crosses
  the host boundary, so probing a 16M state costs one tiny collective +
  one scalar fetch (~the dispatch latency), not a state download.
* ``HealthMonitor`` — periodic-probe bookkeeping for a driver loop:
  remembers the last state that probed healthy (JAX arrays are
  immutable, so "remembering" is one reference, not a copy), raises
  :class:`NonFiniteStateError` carrying the last-good snapshot when a
  probe fails, and — in ``retry-halved`` mode — schedules ONE replay of
  the failed segment at half the time step before giving up.

The retry mode deliberately changes the discretization for the replayed
segment (dt/2); that is logged loudly and is opt-in
(``model.on_nonfinite = retry-halved``), because a blowup that a smaller
step cures is a stability failure, not a data failure.  Anything the
retry does not cure aborts exactly like ``abort`` mode: the driver
writes a post-mortem checkpoint (the poisoned state) and a last-good
checkpoint, then re-raises.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

from ..utils.logged import Logged


class NonFiniteStateError(RuntimeError):
    """A health probe found NaN/Inf in the model state.

    Carries the failing step and the last snapshot that probed healthy
    so the driver can checkpoint both sides of the failure.
    """

    def __init__(self, step: int, t: float, last_good: Optional[Tuple]):
        msg = f"non-finite model state detected at step {step} (t={t})"
        if last_good is not None:
            msg += f"; last healthy state was step {last_good[0]} (t={last_good[1]})"
        super().__init__(msg)
        self.step = step
        self.t = t
        #: (step, t, state) of the newest probe that passed, or None.
        self.last_good = last_good


@functools.lru_cache(maxsize=None)
def _jitted_all_finite():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def all_finite(leaves):
        flags = [jnp.isfinite(leaf).all() for leaf in leaves]
        return functools.reduce(jnp.logical_and, flags)

    return all_finite


def finite_probe(state: Any) -> bool:
    """True iff every leaf of ``state`` is everywhere finite.

    One fused JITTED reduction; works on replicated, GSPMD-sharded and
    shard_map-produced global arrays alike, including multi-process
    (multi-host) global arrays whose shards are not all addressable — eager
    ops would raise there, but a jitted reduce lowers to a sharded
    collective and returns a replicated scalar on every process.
    """
    import jax

    leaves = [x for x in jax.tree_util.tree_leaves(state) if hasattr(x, "dtype")]
    if not leaves:
        return True
    return bool(_jitted_all_finite()(leaves))


class HealthMonitor:
    """Periodic finite-state probing with optional halved-dt replay.

    Driver contract (see ``runtime/coupled_main.py``)::

        mon = HealthMonitor(period, mode)
        mon.record_good(0, t0, state)           # the initial state
        while stepping:
            dt_cur = dt / 2 if mon.recovering else dt
            state = step(state, ..., dt_cur)
            ...
            action = mon.after_step(step, t, state)
            if action == "rollback":
                step, t, state = mon.rollback_target()

    ``after_step`` returns ``"ok"`` (keep going), ``"rollback"`` (restore
    the last-good snapshot and replay at dt/2) or raises
    :class:`NonFiniteStateError`.  Probes run every ``period`` completed
    full steps, plus at the end of a recovery segment.
    """

    def __init__(self, period: int, mode: str = "abort", probe=finite_probe):
        if mode not in ("abort", "retry-halved"):
            raise ValueError(f"unknown on_nonfinite mode '{mode}'")
        self.period = int(period)
        self.mode = mode
        self.probe = probe
        self._last_good: Optional[Tuple[int, float, Any]] = None
        #: >0 while replaying a failed segment at dt/2 (counts remaining
        #: half-steps); the driver reads ``recovering``.
        self._recovery_left = 0
        #: set when the active recovery segment already used its retry;
        #: a second failure of the same segment aborts.
        self._retry_spent = False

    # -- driver-facing state ------------------------------------------------
    @property
    def recovering(self) -> bool:
        return self._recovery_left > 0

    @property
    def last_good(self) -> Optional[Tuple[int, float, Any]]:
        return self._last_good

    def record_good(self, step: int, t: float, state: Any) -> None:
        """Pin ``state`` as the newest known-healthy snapshot."""
        self._last_good = (step, t, state)

    # -- probing ------------------------------------------------------------
    def due(self, step: int) -> bool:
        """Is a probe due after completed full step ``step``?"""
        if self.period <= 0:
            return False
        if self.recovering:
            return False  # probed at segment end via after_step
        return step % self.period == 0

    def after_step(self, step: int, t: float, state: Any) -> str:
        """Advance the monitor after one completed step (full or half).

        Returns "ok" or "rollback"; raises NonFiniteStateError when the
        failure is terminal (abort mode, or a spent retry).
        """
        if self.period <= 0:
            return "ok"
        if self._recovery_left > 0:
            self._recovery_left -= 1
            if self._recovery_left > 0:
                return "ok"  # mid-segment: keep replaying
            # Segment replayed: probe it.
            if self.probe(state):
                Logged.warning(
                    f"health: halved-dt replay healthy again at step {step}; "
                    "resuming the configured time step"
                )
                self._retry_spent = False
                self.record_good(step, t, state)
                return "ok"
            raise NonFiniteStateError(step, t, self._last_good)
        if not self.due(step):
            return "ok"
        if self.probe(state):
            self.record_good(step, t, state)
            return "ok"
        # Probe failed.
        if self.mode == "abort" or self._retry_spent or self._last_good is None:
            raise NonFiniteStateError(step, t, self._last_good)
        good_step = self._last_good[0]
        segment = step - good_step
        self._recovery_left = 2 * segment
        self._retry_spent = True
        Logged.error(
            f"health: non-finite state at step {step}; rolling back to "
            f"step {good_step} and replaying {segment} step(s) at dt/2"
        )
        return "rollback"

    def rollback_target(self) -> Tuple[int, float, Any]:
        """The (step, t, state) snapshot the driver must restore."""
        assert self._last_good is not None
        return self._last_good
