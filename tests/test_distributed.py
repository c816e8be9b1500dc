"""Multi-host init hardening + EnumWrapper config wiring."""

import pytest


def test_initialize_noop_when_env_autodetect_fails(monkeypatch):
    """The no-argument form may fall back to local devices."""
    import jax

    from nextsimdg_tpu.parallel import distributed

    def boom(**kwargs):
        raise RuntimeError("no coordinator configured")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    distributed.initialize()  # must not raise
    assert not distributed.is_multi_host()


def test_initialize_raises_on_explicit_coordinates(monkeypatch):
    """A configured multi-host launch must fail LOUDLY, not degrade to 1 host."""
    import jax

    from nextsimdg_tpu.parallel import distributed

    def boom(**kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="refusing to degrade"):
        distributed.initialize(
            coordinator_address="10.0.0.1:1234", num_processes=4, process_id=0
        )


def test_initialize_passes_coordinates_through(monkeypatch):
    import jax

    from nextsimdg_tpu.parallel import distributed

    seen = {}

    def fake(**kwargs):
        seen.update(kwargs)

    monkeypatch.setattr(jax.distributed, "initialize", fake)
    distributed.initialize(
        coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2
    )
    assert seen == dict(
        coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2
    )


def test_enum_wrapper_rejects_unknown_geometry():
    """EnumWrapper (EnumWrapper.hpp:58-112 port) raises on unmapped tokens;
    the coupled CLI wires it to dynamics.geometry."""
    from nextsimdg_tpu.runtime.coupled_main import _GEOMETRY, Geometry

    assert _GEOMETRY("cartesian") is Geometry.CARTESIAN
    assert _GEOMETRY(" spherical ") is Geometry.SPHERICAL
    with pytest.raises(ValueError, match="cylindrical"):
        _GEOMETRY("cylindrical")
