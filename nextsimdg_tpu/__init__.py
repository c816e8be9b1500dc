"""nextsimdg_tpu — a sea-ice model framework for accelerators.

A from-scratch JAX/XLA re-design of the capabilities of
draenog/nextsimdg (the neXtSIM_DG discontinuous-Galerkin sea-ice model):

* ``config``    — Configurator/Configured/ConfiguredModule config stack
* ``modules``   — runtime-selectable module registry
* ``state``     — ModelState pytree (structure-of-arrays fields)
* ``physics``   — column thermodynamics as pure, maskable JAX functions
* ``dynamics``  — DG transport + mEVP rheology
* ``grid``      — model structures (DevGrid, RectGrid) + netCDF restart I/O
* ``parallel``  — SPMD domain decomposition, halo exchange over device meshes
* ``runtime``   — Model facade, Iterator time loop, CLI driver
* ``utils``     — timers, logging

Numerics note: the thermodynamics column physics follows the reference's
float64 arithmetic when the state is f64 (tests run with ``jax_enable_x64``
on CPU); the coupled model runs in f32 on the accelerator by default.
"""

__version__ = "0.1.0"
