"""The staged DG transport: mass conservation and positivity.

The coupled step advects its tracers with ``DGTransport.step(...,
limit=True)``; over dG0-dG2, closed and periodic domains, with and
without the TVB slope limiter, a sharp nonnegative tracer in a sheared,
divergent velocity must keep its total mass to round-off and stay
nonnegative at every evaluation point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nextsimdg_tpu.dynamics import DGTransport, RectMesh
from nextsimdg_tpu.dynamics.transport import sample_velocity
from tests.test_limiter import _pointwise_min


def _velocity(x, y):
    # Sheared and divergent; vanishes nowhere in the interior.
    return (
        1.0 + 0.5 * np.sin(2 * np.pi * y),
        0.5 * np.cos(2 * np.pi * x) + 0.25 * np.sin(2 * np.pi * y),
    )


def _square(x, y):
    return np.where((np.abs(x - 0.4) < 0.15) & (np.abs(y - 0.5) < 0.2), 1.0, 0.0)


@pytest.mark.parametrize("tvb_m", [None, 50.0], ids=["positivity", "tvb"])
@pytest.mark.parametrize("periodic", [False, True], ids=["closed", "periodic"])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_transport_conserves_mass_and_positivity(degree, periodic, tvb_m):
    n = 16
    mesh = RectMesh(
        nx=n, ny=n, dx=1.0 / n, dy=1.0 / n,
        periodic_x=periodic, periodic_y=periodic,
    )
    tr = DGTransport(mesh, degree=degree, tvb_m=tvb_m)
    vel = sample_velocity(mesh, tr.basis, _velocity, dtype=jnp.float64)
    psi = tr.project(_square, dtype=jnp.float64)
    # Advective CFL 0.1 / (2p + 1) at the largest speed (~1.9).
    dt = 0.1 / (2 * degree + 1) / (1.9 * n)
    mass0 = float(tr.total_mass(psi))
    step = jax.jit(lambda p: tr.step(p, vel, dt, limit=True))
    for _ in range(40):
        psi = step(psi)
    assert np.all(np.isfinite(np.asarray(psi)))
    # Closed walls are impermeable; periodic faces wrap.
    np.testing.assert_allclose(float(tr.total_mass(psi)), mass0, rtol=1e-12)
    assert float(jnp.min(psi[0])) >= -1e-14
    if degree > 0:
        assert float(jnp.min(_pointwise_min(tr, psi))) >= -1e-12
    # The tracer actually moved.
    start = tr.project(_square, dtype=jnp.float64)[0]
    assert not np.allclose(np.asarray(psi[0]), np.asarray(start))
