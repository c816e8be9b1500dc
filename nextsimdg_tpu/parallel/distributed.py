"""Multi-host initialization.

Extends the device mesh across hosts: each host runs the same SPMD
program; JAX's runtime routes collectives within a host over its device
links and cross-host traffic over the network. No separate message-passing
runtime is needed (SURVEY.md section 5: the replacement for the absent MPI
layer).

Typical multi-host launch (one process per host)::

    from nextsimdg_tpu.parallel import distributed
    distributed.initialize(coordinator_address=..., num_processes=...,
                           process_id=...)
    mesh = make_spatial_mesh()           # all global devices
    ...

Pass ``coordinator_address``, ``num_processes`` and ``process_id``
explicitly where the cluster environment does not provide them.
"""

from __future__ import annotations

from typing import Optional

import jax

#: Set after a successful initialize() — jax.process_count() cannot detect
#: a prior num_processes=1 init, so idempotency needs its own flag.
_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (idempotent).

    With explicit coordinates (a configured pod/cluster launch), an init
    failure is an ERROR — silently degrading to single-host would run the
    science on 1/N of the domain. Only the no-argument, env-autodetected
    form is allowed to fall back to local devices.
    """
    global _initialized
    if _initialized or jax.process_count() > 1:
        return  # already initialized
    explicit = any(
        arg is not None
        for arg in (coordinator_address, num_processes, process_id)
    )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as err:
        if explicit:
            raise RuntimeError(
                "jax.distributed.initialize failed for an explicitly "
                f"configured multi-host launch ({coordinator_address=}, "
                f"{num_processes=}, {process_id=}); refusing to degrade "
                "to single-host"
            ) from err
        # Single-process environments (no coordinator configured): proceed
        # with the local devices only.
        return
    _initialized = True


def is_multi_host() -> bool:
    return jax.process_count() > 1


def local_device_count() -> int:
    return jax.local_device_count()


def global_device_count() -> int:
    return jax.device_count()
