"""mEVP (modified elastic-viscous-plastic) momentum and rheology solver.

North-star capability (BASELINE.json: "mEVP-subcycled momentum/rheology
solver (CG velocity nodes, strain-rate/stress tensor updates)"). The
reference snapshot contains no dynamics; this follows the standard mEVP
formulation (Bouillon et al. 2013; Kimmritz et al. 2015/2016) used by
neXtSIM_DG's dynamical core:

* velocity (u, v) on CG1 nodes (nx+1, ny+1);
* stress (s11, s22, s12) and strain rates per element (element-wise constant
  this round; higher-order stress is a later extension);
* per subcycle: strain rates from bilinear velocity gradients -> VP stress
  with ellipse ratio e and replacement pressure -> alpha-relaxation of the
  stress -> weak-form stress divergence assembled to nodes -> beta-relaxed
  velocity update with semi-implicit ocean drag and explicit Coriolis;
* Dirichlet (no-slip) boundary + land mask on nodes.

Device mapping: each subcycle is ~15 elementwise passes over (nx, ny)-sized
arrays plus 2x2 corner gathers — memory-bound elementwise work that XLA
fuses; the subcycle loop is a ``lax.fori_loop`` living entirely on device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from .mesh import RectMesh


def _pytree(cls):
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )


@dataclass(frozen=True)
class MEVPParams:
    """Physical + numerical parameters (VP rheology and mEVP relaxation)."""

    rho_ice: float = 917.0  #: ice density [kg m-3]
    rho_atm: float = 1.225  #: air density [kg m-3]
    rho_ocean: float = 1026.0  #: ocean water density [kg m-3]
    cd_atm: float = 1.2e-3  #: air drag coefficient
    cd_ocean: float = 5.5e-3  #: water drag coefficient
    p_star: float = 27500.0  #: ice strength [N m-2]
    ellipse: float = 2.0  #: ellipse aspect ratio e
    c_compaction: float = 20.0  #: strength compaction constant C
    delta_min: float = 2e-9  #: minimum Delta [s-1]
    alpha: float = 1500.0  #: mEVP stress relaxation
    beta: float = 1500.0  #: mEVP velocity relaxation
    f_coriolis: float = 1.46e-4  #: Coriolis parameter [s-1]
    use_coriolis: bool = True
    min_ice_mass: float = 1.0  #: [kg m-2] below which nodes are held at rest
    #: Scale BOTH surface stresses by the ice concentration:
    #: rho H dv/dt = div(sigma) + A tau_a + A tau_w (v_w - v) — the
    #: canonical VP/mEVP momentum equation (Mehlmann & Richter box test;
    #: the neXtSIM_DG formulation; Hibler 1979 eq. 1 scales per unit ice
    #: area). Off by default for continuity with the unweighted benchmark
    #: configs measured in rounds 1-3.
    a_weighted_stress: bool = False
    #: Nodal concentration below which dynamics nodes are held at rest
    #: when ``a_weighted_stress`` is on (CICE's ``iceumask`` pattern):
    #: at near-zero A the A-scaled ocean drag loses the stabilizing
    #: semi-implicit term while the (unscaled) stress divergence of
    #: adjacent pack can keep pushing — pinning sub-threshold nodes is
    #: what makes the weighted form stable in the marginal ice zone.
    #: 0.05 measured as the lowest decade keeping the wind-8 box's
    #: 2000-step MIZ velocities in the unweighted run's noise band
    #: (0.01 -> 1.2e3 m/s spikes, 0.05 -> 3.4, 0.15 -> 0.96).
    a_dyn_min: float = 5e-2
    #: Adaptive stabilization (the aEVP idea, Kimmritz/Danilov/Losch
    #: 2016): per-node alpha = beta = max(alpha_min,
    #: c_stab sqrt(zeta dt / (m A))) recomputed every subcycle instead
    #: of one global constant. The stability bound of the EVP
    #: pseudo-time iteration scales with sqrt(zeta dt / (m A)), so a
    #: fixed alpha must be tuned for the STIFFEST node of a run (fine
    #: cells, thin ice, strong gradients) and over-relaxes everywhere
    #: else; the adaptive form puts each node at its own bound —
    #: uniform-stability on graded meshes without retuning. Rides every
    #: backend (all of them trace the same subcycle_body; alpha is a
    #: computed plane, no extra const planes).
    adaptive_alpha: bool = False
    alpha_min: float = 150.0  #: floor of the adaptive alpha/beta
    #: Proportionality of the adaptive alpha/beta. The EVP pseudo-time
    #: iteration is stable for alpha*beta > zeta dt pi^2 / (m A) (the
    #: bound behind the fixed alpha=beta=1500 default, cf. the VP
    #: convergence test), i.e. alpha = beta > pi sqrt(zeta dt/(m A));
    #: the default 2 pi sits at twice the bound.
    c_stab: float = 6.2832  #: ~2 pi


@_pytree
@dataclass(frozen=True)
class VelocityState:
    """Dynamics state: CG1 velocity + element stresses (owned-node layout).

    Node (i, j) for i in [0, nx), j in [0, ny) — the i=nx / j=ny boundary
    nodes are implicit (Dirichlet-zero when closed, wrap when periodic); see
    ``dynamics.stencil``. All arrays are (nx, ny): uniform device sharding.
    """

    u: jax.Array  #: x velocity at owned nodes (nx, ny) [m s-1]
    v: jax.Array  #: y velocity at owned nodes (nx, ny)
    s11: jax.Array  #: stress components per element (nx, ny)
    s22: jax.Array
    s12: jax.Array

    @classmethod
    def zeros(cls, nx: int, ny: int, dtype=jnp.float32) -> "VelocityState":
        nodes = jnp.zeros((nx, ny), dtype=dtype)
        cells = jnp.zeros((nx, ny), dtype=dtype)
        return cls(u=nodes, v=nodes, s11=cells, s22=cells, s12=cells)


@_pytree
@dataclass(frozen=True)
class DynamicsForcing:
    """Wind and ocean-current forcing at owned CG nodes (nx, ny)."""

    u_atm: jax.Array
    v_atm: jax.Array
    u_ocean: jax.Array
    v_ocean: jax.Array

    @classmethod
    def zeros(cls, nx: int, ny: int, dtype=jnp.float32) -> "DynamicsForcing":
        nodes = jnp.zeros((nx, ny), dtype=dtype)
        return cls(u_atm=nodes, v_atm=nodes, u_ocean=nodes, v_ocean=nodes)


def _metric(value, dtype):
    """Mesh metric factor as a weak scalar or a dtype-matched array (so f64
    numpy metric planes/np.float64 scalars never promote an f32 state
    inside fori_loop)."""
    if isinstance(value, (int, float)):  # incl. np.float64 (float subclass)
        return float(value)
    return jnp.asarray(value, dtype=dtype)


def cell_to_node(cell, periodic_x: bool = False, periodic_y: bool = False, spmd=(None, None)):
    """Average the 4 adjacent element values to each owned node.

    Lumped-mass CG1 projection. Closed boundaries zero-fill the missing
    neighbors (those nodes are Dirichlet-masked anyway).
    """
    from .stencil import shift_m

    cm_x = shift_m(cell, 0, periodic_x, spmd[0])
    cm_y = shift_m(cell, 1, periodic_y, spmd[1])
    cm_xy = shift_m(cm_x, 1, periodic_y, spmd[1])
    return 0.25 * (cell + cm_x + cm_y + cm_xy)


#: Backends every mEVP solver accepts. 'blocked' selects the ghost-zone
#: halo exchange under shard_map and is the plain XLA loop outside it.
BACKENDS = ("auto", "xla", "blocked")


def check_backend(backend: str) -> str:
    """Validate a solver backend string (raises ValueError listing BACKENDS)."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown mEVP backend {backend!r}; accepted: {', '.join(BACKENDS)}"
        )
    return backend


def pick_block_halo(nx: int, ny: int) -> int:
    """Ghost-zone width for the blocked exchange ('auto'): 16, clamped
    because the exchange strips are h-wide slices of the local block, so
    h can never exceed the block extents (tiny test blocks)."""
    return max(1, min(16, nx, ny))


class MEVPSolver:
    def __init__(
        self,
        mesh: RectMesh,
        params: MEVPParams = MEVPParams(),
        backend: str = "auto",
        spmd=(None, None),
        block_halo=16,
    ) -> None:
        """``backend``: one of ``BACKENDS``. ``spmd``: mesh axis names when
        running inside shard_map. Under shard_map 'auto' and 'xla' exchange
        width-1 halos via ppermute EVERY subcycle; ``backend='blocked'``
        instead widens the local block by ``block_halo`` ghost cells once
        per ``block_halo`` subcycles (one ppermute pair per axis per round)
        — ~8x block_halo fewer messages at ((n+2H)/n)^2 redundant compute."""
        self.mesh = mesh
        self.params = params
        self.backend = check_backend(backend)
        self.spmd = tuple(spmd)
        if block_halo == "auto":
            block_halo = pick_block_halo(mesh.nx, mesh.ny)
        self.block_halo = int(block_halo)

    def _kernel_choice(self) -> str:
        """'blocked' (shard_map ghost zones) or 'xla'."""
        if self.backend == "blocked" and any(axis is not None for axis in self.spmd):
            # Non-uniform geometry under shard_map must arrive as a
            # LocalMeshView (per-device traced metric planes riding the
            # consts); a plain non-uniform RectMesh would replicate ONE
            # block's static metric onto every device.
            if not (self.mesh.uniform or self.mesh.is_local_view):
                raise NotImplementedError(
                    "blocked exchange under shard_map needs a uniform "
                    "local mesh or a LocalMeshView of the global mesh"
                )
            return "blocked"
        return "xla"

    def _metric_planes(self, dtype):
        """None when uniform; dict(area, inv_dx, inv_dy, half_dx, half_dy)
        of full (nx, ny) planes otherwise. LocalMeshView meshes (shard_map
        over a non-uniform global mesh) dynamic-slice this device's block
        of the global metric; plain non-uniform meshes build their planes
        on device from the 1-D metric factors."""
        mesh = self.mesh
        if mesh.uniform:
            return None
        if mesh.is_local_view:
            m = mesh.local_metric(self.spmd, dtype)
        else:
            # On-device outer products of the 1-D metric factors — NOT
            # (nx, ny) numpy literals, which bloat the compiled module by
            # a full plane per metric. Bit-identical at f64 to the
            # numpy-broadcast planes.
            from .mesh import device_metric_planes

            m = device_metric_planes(mesh, dtype)
        return {
            "area": m["area"],
            "inv_dx": 1.0 / m["dx"],
            "inv_dy": 1.0 / m["dy"],
            "half_dx": 0.5 * m["dx"],
            "half_dy": 0.5 * m["dy"],
        }

    # -- per-element strain rates from CG1 velocity --------------------------
    def strain_rates(self, u, v, metric=None):
        """(e11, e22, e12) at element centers from bilinear gradients.

        Element (i, j) reads owned nodes (i, j), (i+1, j), (i, j+1),
        (i+1, j+1); +1 shifts supply the implicit boundary values.
        ``metric``: optional (inv_dx, inv_dy) full per-element planes —
        how graded/spherical widths reach the subcycle (the planes ride
        the consts; see ``step_consts``).
        """
        from .stencil import shift_p

        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax_x, ax_y = self.spmd
        u00, v00 = u, v
        u10, v10 = shift_p(u, 0, px, ax_x), shift_p(v, 0, px, ax_x)
        u01, v01 = shift_p(u, 1, py, ax_y), shift_p(v, 1, py, ax_y)
        u11 = shift_p(u10, 1, py, ax_y)
        v11 = shift_p(v10, 1, py, ax_y)
        if metric is not None:
            inv_dx, inv_dy = metric
            du_dx = 0.5 * ((u10 - u00) + (u11 - u01)) * inv_dx
            dv_dy = 0.5 * ((v01 - v00) + (v11 - v10)) * inv_dy
            du_dy = 0.5 * ((u01 - u00) + (u11 - u10)) * inv_dy
            dv_dx = 0.5 * ((v10 - v00) + (v11 - v01)) * inv_dx
            return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)
        dx = _metric(self.mesh.dx, u.dtype)
        dy = _metric(self.mesh.dy, u.dtype)
        du_dx = 0.5 * ((u10 - u00) + (u11 - u01)) / dx
        dv_dy = 0.5 * ((v01 - v00) + (v11 - v10)) / dy
        du_dy = 0.5 * ((u01 - u00) + (u11 - u10)) / dy
        dv_dx = 0.5 * ((v10 - v00) + (v11 - v01)) / dx
        return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)

    # -- weak-form divergence of element-constant stress to nodes ------------
    def stress_divergence(self, s11, s22, s12, metric=None):
        """Nodal forces (Fu, Fv) = -int sigma : grad(phi), per unit length.

        For bilinear phi on a rectangle, int_E dphi/dx dA = +-dy/2 (sign by
        which side of E the node is on) and int_E dphi/dy dA = +-dx/2, so
        assembly is a signed 2x2 corner gather: node (i, j) reads elements
        (i-1, j-1), (i-1, j), (i, j-1), (i, j).
        ``metric``: optional (half_dx, half_dy) full per-element planes
        (graded/spherical meshes; see ``step_consts``) — each element
        weighted by ITS OWN face length before shifting.
        """
        from .stencil import shift_m

        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax_x, ax_y = self.spmd
        if metric is not None:
            half_dx, half_dy = metric

            def scatter_x_m(cell):
                w = cell * half_dy
                wm_x = shift_m(w, 0, px, ax_x)
                wm_y = shift_m(w, 1, py, ax_y)
                wm_xy = shift_m(wm_x, 1, py, ax_y)
                return (wm_y + w) - (wm_xy + wm_x)

            def scatter_y_m(cell):
                w = cell * half_dx
                wm_x = shift_m(w, 0, px, ax_x)
                wm_y = shift_m(w, 1, py, ax_y)
                wm_xy = shift_m(wm_x, 1, py, ax_y)
                return (wm_x + w) - (wm_xy + wm_y)

            fu = scatter_x_m(s11) + scatter_y_m(s12)
            fv = scatter_x_m(s12) + scatter_y_m(s22)
            return fu, fv
        dx = _metric(self.mesh.dx, s11.dtype)
        dy = _metric(self.mesh.dy, s11.dtype)

        # F_n = -int sigma dphi_n/dx: the node's basis ramps UP inside the
        # elements to its left (+dy/2 gradient integral) and DOWN in those
        # to its right, so F = (dy/2)(right elements - left). On uniform
        # meshes the scalar metric factors come out of the shifts, letting
        # XLA share one set of neighbor shifts between scatter_x/scatter_y;
        # graded meshes need each element weighted by ITS OWN face length
        # before shifting.
        if self.mesh.uniform:
            # s12 feeds BOTH force components; computing its three
            # neighbor shifts once (instead of once per scatter) saves 3
            # of 12 shift ops per subcycle. The single-component scatters
            # (s11 -> Fu, s22 -> Fv) factor the signed 2x2 corner gather
            # through a partial sum,
            #   (cm_y + cell) - (cm_xy + cm_x) == t - t[i-1],  t = cell + cm_y
            # which is BIT-identical (a shift of a sum is the sum of the
            # shifts; the adds pair the same operands) at 2 shifts instead
            # of 3 — per subcycle the stress divergence drops from 9 plane
            # shifts to 7 (15 -> 13 total).
            def shifts(cell):
                cm_x = shift_m(cell, 0, px, ax_x)
                cm_y = shift_m(cell, 1, py, ax_y)
                cm_xy = shift_m(cm_x, 1, py, ax_y)
                return cm_x, cm_y, cm_xy

            def scatter_x(cell, sh=None):
                if sh is None:
                    t = cell + shift_m(cell, 1, py, ax_y)
                    return 0.5 * dy * (t - shift_m(t, 0, px, ax_x))
                cm_x, cm_y, cm_xy = sh
                return 0.5 * dy * ((cm_y + cell) - (cm_xy + cm_x))

            def scatter_y(cell, sh=None):
                if sh is None:
                    t = cell + shift_m(cell, 0, px, ax_x)
                    return 0.5 * dx * (t - shift_m(t, 1, py, ax_y))
                cm_x, cm_y, cm_xy = sh
                return 0.5 * dx * ((cm_x + cell) - (cm_xy + cm_y))

            sh12 = shifts(s12)
            fu = scatter_x(s11) + scatter_y(s12, sh12)
            fv = scatter_x(s12, sh12) + scatter_y(s22)
            return fu, fv
        else:

            def scatter_x(cell):
                w = cell * (0.5 * dy)
                wm_x = shift_m(w, 0, px, ax_x)
                wm_y = shift_m(w, 1, py, ax_y)
                wm_xy = shift_m(wm_x, 1, py, ax_y)
                return (wm_y + w) - (wm_xy + wm_x)

            def scatter_y(cell):
                w = cell * (0.5 * dx)
                wm_x = shift_m(w, 0, px, ax_x)
                wm_y = shift_m(w, 1, py, ax_y)
                wm_xy = shift_m(wm_x, 1, py, ax_y)
                return (wm_x + w) - (wm_xy + wm_y)

        fu = scatter_x(s11) + scatter_y(s12)
        fv = scatter_x(s12) + scatter_y(s22)
        return fu, fv

    # -- one outer timestep: N mEVP subcycles --------------------------------
    @partial(jax.jit, static_argnames=("self", "dt", "n_subcycles"))
    def step(
        self,
        state: VelocityState,
        h,  # effective ice thickness per element (nx, ny)
        a,  # ice concentration per element (nx, ny)
        forcing: DynamicsForcing,
        mask,  # 1.0 on active ocean nodes, 0.0 on land/boundary (nx+1, ny+1)
        dt: float,
        n_subcycles: int = 100,
    ) -> VelocityState:
        consts = self.step_consts(state, h, a, forcing, mask, dt)
        carry0 = (state.u, state.v, state.s11, state.s22, state.s12)
        if self._kernel_choice() == "blocked":
            u, v, s11, s22, s12 = self._blocked_subcycles(
                carry0, consts, dt, n_subcycles
            )
        else:
            def subcycle(_, carry):
                return self.subcycle_body(carry, consts, dt)

            u, v, s11, s22, s12 = jax.lax.fori_loop(
                0, n_subcycles, subcycle, carry0
            )
        return VelocityState(u=u, v=v, s11=s11, s22=s22, s12=s12)

    def step_consts(self, state: VelocityState, h, a, forcing, mask, dt: float):
        """The per-step constant planes shared by every backend.

        7 compact planes: dt/m and the constant part of the velocity-update
        numerator (u_n + dt/m tau_a) are precomputed, which removes work
        from the subcycle; graded meshes add per-node inverse weights.
        """
        p = self.params
        dtype = state.u.dtype

        # Element ice strength P = P* h exp(-C (1-A)).
        strength = p.p_star * h * jnp.exp(-p.c_compaction * (1.0 - a))

        # Lumped nodal ice mass per unit area [kg m-2] (area-weighted over
        # the adjacent elements — exact for graded meshes), clamped.
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        metric = self._metric_planes(dtype)
        if metric is None:
            cell_area = jnp.broadcast_to(
                jnp.asarray(self.mesh.cell_area, dtype=dtype), h.shape
            )
        else:
            cell_area = metric["area"]
        node_area = cell_to_node(cell_area, px, py, self.spmd)
        m_node = p.rho_ice * cell_to_node(
            h * cell_area, px, py, self.spmd
        ) / node_area
        ice_node = m_node > p.min_ice_mass
        m_safe = jnp.maximum(m_node, p.min_ice_mass)

        # Wind stress is constant over the subcycles (atmosphere does not
        # feel the ice velocity at these scales).
        tau_au = p.rho_atm * p.cd_atm * jnp.hypot(forcing.u_atm, forcing.v_atm) * forcing.u_atm
        tau_av = p.rho_atm * p.cd_atm * jnp.hypot(forcing.u_atm, forcing.v_atm) * forcing.v_atm

        active = mask * ice_node.astype(dtype)
        dt_m = dt / m_safe
        wind_w = 1.0
        if p.a_weighted_stress:
            # Lumped nodal concentration (area-weighted over the adjacent
            # elements, like m_node), clipped to [0, 1]. It scales the
            # wind stress here (constant over the subcycles) and the
            # ocean drag inside subcycle_body via the extra a_node const
            # plane; nodes below a_dyn_min are pinned at rest through the
            # existing active factor (see MEVPParams.a_dyn_min).
            a_node = jnp.clip(
                cell_to_node(a * cell_area, px, py, self.spmd) / node_area,
                0.0,
                1.0,
            )
            active = active * (a_node >= p.a_dyn_min).astype(dtype)
            wind_w = a_node
        consts = dict(
            strength=strength,
            dt_m=dt_m,
            active=active,
            b_u=state.u + dt_m * wind_w * tau_au,
            b_v=state.v + dt_m * wind_w * tau_av,
            u_ocean=forcing.u_ocean,
            v_ocean=forcing.v_ocean,
        )
        if p.a_weighted_stress:
            consts["a_node"] = a_node
        if metric is not None:
            # Per-node quarter-area weights for the force normalization,
            # plus the per-element metric planes (inv widths for the
            # strain gradients, half face-lengths for the stress-divergence
            # scatter weights). Full (nx, ny) planes — the land-mask
            # pattern — so the blocked exchange widens them like any other
            # const. For a LocalMeshView the planes are this device's
            # traced block of the global metric (bit-identical at f64 to
            # the static single-device planes — tests/test_shardmap_metric.py).
            consts["inv_w"] = 1.0 / node_area
            consts["inv_dx"] = metric["inv_dx"]
            consts["inv_dy"] = metric["inv_dy"]
            consts["half_dx"] = metric["half_dx"]
            consts["half_dy"] = metric["half_dy"]
        return consts

    def _blocked_subcycles(self, carry0, consts, dt, n_subcycles):
        """Ghost-zone ("temporally blocked") halo exchange under shard_map.

        Widen every plane by H ghost cells from the neighbor devices (ONE
        ppermute pair per axis), run H subcycles on the widened local block
        with plain closed-boundary shifts (the exchange already supplied
        neighbor data; global walls arrive as zero strips), keep the
        interior, repeat. Each subcycle invalidates one ghost ring, so the
        interior stays EXACTLY equal to the per-subcycle-exchange result.
        The collectives (one ppermute pair per axis per H subcycles) live
        outside the widened-block solve, which is the plain XLA loop.
        """
        from .stencil import halo_widen

        h = self.block_halo
        nx, ny = self.mesh.nx, self.mesh.ny
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax_x, ax_y = self.spmd

        def widen(f):
            f = halo_widen(f, h, 0, px, ax_x)
            return halo_widen(f, h, 1, py, ax_y)

        # A local solver on the widened block: closed shifts, no spmd.
        # Non-uniform geometry (LocalMeshView) travels entirely via the
        # widened metric const planes — subcycle_body keys on the consts,
        # so the shim mesh is a unit uniform mesh then (zero ghost metric
        # beyond global walls is inert: every metric use is a multiply).
        local = MEVPSolver(
            RectMesh(
                nx=nx + 2 * h, ny=ny + 2 * h,
                dx=self.mesh.dx if self.mesh.uniform else 1.0,
                dy=self.mesh.dy if self.mesh.uniform else 1.0,
            ),
            self.params,
            backend="xla",
        )
        consts_w = {name: widen(value) for name, value in consts.items()}

        def round_body(carry, n_sub):
            padded = tuple(widen(f) for f in carry)

            def sub(_, c):
                return local.subcycle_body(c, consts_w, dt)

            padded = jax.lax.fori_loop(0, n_sub, sub, padded)
            return tuple(p[h : h + nx, h : h + ny] for p in padded)

        carry = carry0
        remaining = n_subcycles
        while remaining > 0:
            n_sub = min(h, remaining)
            remaining -= n_sub
            carry = round_body(carry, n_sub)
        return carry

    def subcycle_body(self, carry, consts, dt):
        """One mEVP subcycle — shared by the single-device and blocked paths.

        ``carry``: (u, v, s11, s22, s12); ``consts``: 7 per-step constant
        planes: ice strength, dt/m, the active (mask*ice) factor, the
        constant numerator terms b_u/b_v = u_n + (dt/m) tau_a, and the ocean
        currents.
        """
        p = self.params
        e2 = p.ellipse * p.ellipse
        alpha, beta = p.alpha, p.beta
        u, v, s11, s22, s12 = carry
        strength = consts["strength"]
        dt_m = consts["dt_m"]
        active = consts["active"]
        b_u, b_v = consts["b_u"], consts["b_v"]
        u_ocean, v_ocean = consts["u_ocean"], consts["v_ocean"]

        # 1. strain rates and Delta (metric planes when graded/spherical).
        graded = "inv_dx" in consts
        e11, e22, e12 = self.strain_rates(
            u, v,
            metric=(consts["inv_dx"], consts["inv_dy"]) if graded else None,
        )
        delta = jnp.sqrt(
            (e11 * e11 + e22 * e22) * (1.0 + 1.0 / e2)
            + 2.0 * e11 * e22 * (1.0 - 1.0 / e2)
            + 4.0 / e2 * e12 * e12
        )
        # Replacement pressure: P Delta/(Delta+Delta_min). The rheology
        # denominator (Delta + Delta_min) and the drag denominator
        # (1 + beta + dt_m c_w, step 4) share ONE division via
        # 1/a = (1/(a b)) b, trading the second divide for three
        # multiplies. c_w is hoisted here for the fused product.
        rel_u = consts["u_ocean"] - u
        rel_v = consts["v_ocean"] - v
        c_w = p.rho_ocean * p.cd_ocean * jnp.sqrt(rel_u * rel_u + rel_v * rel_v)
        if "a_node" in consts:
            # A-weighted ocean stress: tau_w = A c_w (v_w - v). One extra
            # multiply per subcycle; the plane rides the consts like the
            # metric planes do.
            c_w = c_w * consts["a_node"]
        denom_rheo = delta + p.delta_min
        if p.adaptive_alpha:
            # aEVP-style per-node stabilization (see MEVPParams): alpha
            # depends on zeta, so the rheology divide cannot share the
            # drag divide — two divides + one sqrt extra per subcycle.
            inv_denom = 1.0 / denom_rheo
            zeta = 0.5 * strength * inv_denom
            if "inv_w" in consts:
                inv_area = consts["inv_w"]
            else:
                inv_area = 1.0 / (self.mesh.dx * self.mesh.dy)
            alpha = jnp.maximum(
                p.alpha_min, p.c_stab * jnp.sqrt(zeta * dt_m * inv_area)
            )
            beta = alpha
            inv_drag = active / (1.0 + beta + dt_m * c_w)
        else:
            denom_drag = 1.0 + beta + dt_m * c_w
            inv_both = 1.0 / (denom_rheo * denom_drag)
            inv_denom = inv_both * denom_drag
            inv_drag = active * (inv_both * denom_rheo)
            zeta = 0.5 * strength * inv_denom
        eta = zeta * (1.0 / e2)
        p_rep = strength * delta * inv_denom

        # 2. VP stress and mEVP alpha-relaxation (1/alpha is a compile-time
        # constant multiply; a per-node plane in the adaptive form).
        inv_alpha = 1.0 / alpha
        div = e11 + e22
        s11_vp = 2.0 * eta * e11 + (zeta - eta) * div - 0.5 * p_rep
        s22_vp = 2.0 * eta * e22 + (zeta - eta) * div - 0.5 * p_rep
        s12_vp = 2.0 * eta * e12
        s11 = s11 + (s11_vp - s11) * inv_alpha
        s22 = s22 + (s22_vp - s22) * inv_alpha
        s12 = s12 + (s12_vp - s12) * inv_alpha

        # 3. stress divergence -> nodal force per unit area: F_raw / W_node
        # with W = sum of adjacent quarter-areas (= dx*dy on uniform
        # interiors; per-node plane via consts["inv_w"] on graded meshes).
        fu, fv = self.stress_divergence(
            s11, s22, s12,
            metric=(consts["half_dx"], consts["half_dy"]) if graded else None,
        )
        if "inv_w" in consts:
            inv_w = consts["inv_w"]
        else:
            inv_w = 1.0 / (self.mesh.dx * self.mesh.dy)
        fu = fu * inv_w
        fv = fv * inv_w

        # 4. beta-relaxed velocity update, semi-implicit ocean drag
        # (c_w and inv_drag hoisted into the shared division of step 1;
        # the Dirichlet mask is folded into inv_drag there).
        cor_u = p.f_coriolis * (v - v_ocean) if p.use_coriolis else 0.0
        cor_v = -p.f_coriolis * (u - u_ocean) if p.use_coriolis else 0.0
        u_new = (
            beta * u + b_u + dt_m * (fu + c_w * u_ocean) + dt * cor_u
        ) * inv_drag
        v_new = (
            beta * v + b_v + dt_m * (fv + c_w * v_ocean) + dt * cor_v
        ) * inv_drag

        # 5. Dirichlet mask (inv_drag includes it): land and ice-free nodes
        # stay at rest.
        return (u_new, v_new, s11, s22, s12)

    def boundary_mask(self, dtype=jnp.float32):
        """1 on interior owned nodes, 0 on no-slip walls.

        Closed axes pin the stored i=0 / j=0 nodes (the i=nx / j=ny nodes
        are implicit and always zero); periodic axes have no walls. Inside
        shard_map only the GLOBAL first block's edge row/col is a wall.
        """
        from .stencil import is_global_edge

        nx, ny = self.mesh.nx, self.mesh.ny
        ax_x, ax_y = self.spmd
        # Traced iota construction in ALL modes (outside shard_map
        # is_global_edge is a static True): a numpy mask would embed an
        # (nx, ny) literal in the module — 67 MB at 16M elements.
        mask = jnp.ones((nx, ny), dtype=dtype)
        if not self.mesh.periodic_x:
            row0 = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 0) == 0
            mask = jnp.where(row0 & is_global_edge(ax_x, "first"), 0.0, mask)
        if not self.mesh.periodic_y:
            col0 = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 1) == 0
            mask = jnp.where(col0 & is_global_edge(ax_y, "first"), 0.0, mask)
        return mask
