"""Test configuration.

Tests run on the CPU backend with a virtual 8-device mesh (so multi-device
sharding is exercised without accelerators) and with float64 enabled (the
reference physics is all C++ ``double``; golden values are pinned at 1e-4).
These env vars must be set before JAX is imported anywhere.
"""

import os

# The f64 correctness tests run on the host CPU with a virtual 8-device
# mesh, whatever accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from nextsimdg_tpu.config import Configurator  # noqa: E402
from nextsimdg_tpu.modules import ModuleRegistry  # noqa: E402


@pytest.fixture(autouse=True)
def clean_config():
    """Reset the static Configurator and module selections around each test.

    The reference tests do this manually (Configurator::clearStreams() at the
    top of every case); here it is automatic.
    """
    Configurator.clear()
    ModuleRegistry.get_loader().reset()
    yield
    Configurator.clear()
    ModuleRegistry.get_loader().reset()
