"""Higher-order mEVP: CG2 velocity + dG1 stress (the neXtSIM_DG core).

This is the discretization of the actual neXtSIM_DG dynamical core (cf.
BASELINE.json north star: higher-order DG methods): biquadratic CG2
velocity, strain/stress tensors in dG1 (3 coefficients per component), with
the nonlinear VP constitutive law evaluated at Gauss points and projected
back — versus the classical CG1 / element-constant-stress solver in
``mevp.py``.

Owned-plane layout: a CG2 scalar field is four (nx, ny) planes (vertex,
bottom-mid, left-mid, center; see ``cg2basis``), so everything shards
evenly over device meshes exactly like the low-order fields, and all
per-element node gathers/scatters are static-table contractions + shifts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .cg2basis import LOCAL_NODE_SOURCE, PLANES, cg2_tables
from .mesh import RectMesh
from .mevp import MEVPParams, check_backend, pick_block_halo
from .stencil import shift_m, shift_p
from .transport import apply_table


def _pytree(cls):
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )


@_pytree
@dataclass(frozen=True)
class HOField:
    """One CG2 scalar field in owned planes (each (nx, ny))."""

    v: jax.Array  #: vertex nodes (i, j)
    b: jax.Array  #: bottom edge midpoints (i+1/2, j)
    l: jax.Array  #: left edge midpoints (i, j+1/2)
    c: jax.Array  #: centers (i+1/2, j+1/2)

    @classmethod
    def zeros(cls, nx: int, ny: int, dtype=jnp.float32) -> "HOField":
        z = jnp.zeros((nx, ny), dtype)
        return cls(v=z, b=z, l=z, c=z)

    @classmethod
    def from_function(cls, mesh: RectMesh, fn, dtype=jnp.float64) -> "HOField":
        """Sample an analytic field at the owned node coordinates.

        Uses the mesh node positions directly, so graded meshes (per-column
        dx / per-row dy) sample at the true physical node locations."""
        xn, yn = mesh.node_coords()  # (nx+1, ny+1) physical corners
        xv = xn[:-1, :-1]
        yv = yn[:-1, :-1]
        xm = 0.5 * (xn[:-1, :-1] + xn[1:, :-1])  # x midpoints per element
        ym = 0.5 * (yn[:-1, :-1] + yn[:-1, 1:])  # y midpoints per element
        coords = {
            "v": (xv, yv),
            "b": (xm, yv),
            "l": (xv, ym),
            "c": (xm, ym),
        }
        values = {}
        for name, (x, y) in coords.items():
            values[name] = jnp.asarray(
                np.broadcast_to(fn(x, y), (mesh.nx, mesh.ny)), dtype=dtype
            )
        return cls(**values)

    @classmethod
    def from_vertex_field(cls, vertex, periodic_x=False, periodic_y=False, spmd=(None, None)):
        """Build mid/center planes by interpolating a vertex (CG1) field."""
        vx = shift_p(vertex, 0, periodic_x, spmd[0])
        vy = shift_p(vertex, 1, periodic_y, spmd[1])
        vxy = shift_p(vx, 1, periodic_y, spmd[1])
        return cls(
            v=vertex,
            b=0.5 * (vertex + vx),
            l=0.5 * (vertex + vy),
            c=0.25 * (vertex + vx + vy + vxy),
        )


@_pytree
@dataclass(frozen=True)
class HOVelocityState:
    """CG2 velocity + dG1 stress coefficients."""

    u: HOField
    v: HOField
    s11: jax.Array  #: (3, nx, ny) dG1 coefficients
    s22: jax.Array
    s12: jax.Array

    @classmethod
    def zeros(cls, nx: int, ny: int, dtype=jnp.float32) -> "HOVelocityState":
        coeffs = jnp.zeros((3, nx, ny), dtype)
        return cls(
            u=HOField.zeros(nx, ny, dtype), v=HOField.zeros(nx, ny, dtype),
            s11=coeffs, s22=coeffs, s12=coeffs,
        )


@_pytree
@dataclass(frozen=True)
class HODynamicsForcing:
    """Wind/ocean forcing as CG2 fields."""

    u_atm: HOField
    v_atm: HOField
    u_ocean: HOField
    v_ocean: HOField


def ho_velocity_to_quad(mesh: RectMesh, basis, u: HOField, v: HOField, spmd=(None, None)):
    """Sample a CG2 velocity at DG transport quadrature points (exact).

    Returns a :class:`~nextsimdg_tpu.dynamics.transport.QuadVelocity`. Volume
    points use the full 9-node CG2 interpolation; faces use the quadratic
    trace through the 3 nodes on each face (single-valued across elements).
    """
    from .transport import QuadVelocity
    from .cg2basis import _lagrange_1d, cg2_sampling_table

    px, py = mesh.periodic_x, mesh.periodic_y
    ax, ay = spmd

    solver_like = MEVPSolverHO(mesh, spmd=spmd)
    u_loc = solver_like.gather_local(u)
    v_loc = solver_like.gather_local(v)
    # Volume points: (9 nodes -> NQ points), at the TRANSPORT basis's
    # (degree-matched) quadrature points.
    n_vol = cg2_sampling_table(basis.degree)
    vx_vol = apply_table(n_vol, u_loc)
    vy_vol = apply_table(n_vol, v_loc)

    # Left face (x=0): nodes v(i,j), l(i,j), v(i,j+1); quadratic in s.
    s = basis.s_edge
    w0 = jnp.asarray(_lagrange_1d(0, s))[:, None, None]
    w1 = jnp.asarray(_lagrange_1d(1, s))[:, None, None]
    w2 = jnp.asarray(_lagrange_1d(2, s))[:, None, None]
    dtype = u.v.dtype
    w0, w1, w2 = w0.astype(dtype), w1.astype(dtype), w2.astype(dtype)
    u_v_up = shift_p(u.v, 1, py, ay)
    vn_x = w0 * u.v[None] + w1 * u.l[None] + w2 * u_v_up[None]
    # Bottom face (y=0): nodes v(i,j), b(i,j), v(i+1,j).
    v_v_right = shift_p(v.v, 0, px, ax)
    vn_y = w0 * v.v[None] + w1 * v.b[None] + w2 * v_v_right[None]
    return QuadVelocity(vx_vol=vx_vol, vy_vol=vy_vol, vn_x=vn_x, vn_y=vn_y)


class MEVPSolverHO:
    """Higher-order mEVP solver. API parallels ``MEVPSolver.step``."""

    def __init__(
        self,
        mesh: RectMesh,
        params: MEVPParams = MEVPParams(),
        backend: str = "auto",  # one of mevp.BACKENDS
        spmd=(None, None),
        block_halo=16,  # ghost-zone width of the blocked exchange
    ) -> None:
        """Under shard_map (``spmd`` set) ``backend='blocked'`` widens the
        local block by ``block_halo`` ghost cells once per ``block_halo``
        subcycles (one ppermute pair per axis per round) — the same
        temporally-blocked exchange as ``MEVPSolver._blocked_subcycles``;
        each HO subcycle's gather(+1)/scatter(-1) pair invalidates exactly
        one ghost ring, so the owned interior stays exactly equal to the
        per-subcycle-exchange result. 'auto' and 'xla' exchange width-1
        halos every subcycle."""
        if params.adaptive_alpha:
            # The adaptive alpha/beta (MEVPParams.adaptive_alpha) needs a
            # consistent element-level alpha (dG1 stress relaxation at
            # Gauss points) AND node-class-level beta planes — not yet
            # designed for the HO discretization. The CG1 solver
            # supports it on every backend.
            raise NotImplementedError(
                "adaptive_alpha is implemented for the CG1 solver only"
            )
        self.mesh = mesh
        self.params = params
        self.backend = check_backend(backend)
        self.spmd = tuple(spmd)
        if block_halo == "auto":
            block_halo = pick_block_halo(mesh.nx, mesh.ny)
        self.block_halo = int(block_halo)
        self.tables = cg2_tables()

    # -- plane <-> local-node machinery --------------------------------------
    def gather_local(self, field: HOField):
        """The 9 local node values of every element, ordered n = 3a + b."""
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax, ay = self.spmd
        planes = {"v": field.v, "b": field.b, "l": field.l, "c": field.c}
        out = []
        for n in range(9):
            a, b = divmod(n, 3)
            plane, sx, sy = LOCAL_NODE_SOURCE[(a, b)]
            arr = planes[plane]
            if sx:
                arr = shift_p(arr, 0, px, ax)
            if sy:
                arr = shift_p(arr, 1, py, ay)
            out.append(arr)
        return jnp.stack(out)  # (9, nx, ny)

    def scatter_local(self, contribs) -> HOField:
        """Accumulate per-element local-node contributions onto owned planes.

        ``contribs``: (9, nx, ny), entry n = contribution of each element to
        its local node n. Adjoint of :meth:`gather_local`.
        """
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax, ay = self.spmd
        planes = {name: None for name in PLANES}
        for n in range(9):
            a, b = divmod(n, 3)
            plane, sx, sy = LOCAL_NODE_SOURCE[(a, b)]
            arr = contribs[n]
            if sx:
                arr = shift_m(arr, 0, px, ax)
            if sy:
                arr = shift_m(arr, 1, py, ay)
            planes[plane] = arr if planes[plane] is None else planes[plane] + arr
        return HOField(**planes)

    def _dx_dy(self, dtype):
        """Per-element (or scalar) metric widths as weak/dtype-safe values."""
        from .mevp import _metric

        return _metric(self.mesh.dx, dtype), _metric(self.mesh.dy, dtype)

    # -- strain: CG2 velocity -> dG1 coefficients ----------------------------
    def strain_rates(self, u: HOField, v: HOField, metric=None):
        """(e11, e22, e12) as (3, nx, ny) dG1 coefficient arrays.

        Graded/spherical meshes: the per-element widths broadcast over the
        leading dG1-dof axis (piecewise-constant metric per element);
        ``metric``: optional (inv_dx, inv_dy) full planes — how the
        widths reach the subcycle (see ``step_consts``)."""
        t = self.tables
        u_loc = self.gather_local(u)
        v_loc = self.gather_local(v)
        if metric is not None:
            inv_dx, inv_dy = metric
            du_dx = apply_table(t.grad_x_to_dg1.T, u_loc) * inv_dx
            du_dy = apply_table(t.grad_y_to_dg1.T, u_loc) * inv_dy
            dv_dx = apply_table(t.grad_x_to_dg1.T, v_loc) * inv_dx
            dv_dy = apply_table(t.grad_y_to_dg1.T, v_loc) * inv_dy
            return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)
        dx, dy = self._dx_dy(u.v.dtype)
        du_dx = apply_table(t.grad_x_to_dg1.T, u_loc) / dx
        du_dy = apply_table(t.grad_y_to_dg1.T, u_loc) / dy
        dv_dx = apply_table(t.grad_x_to_dg1.T, v_loc) / dx
        dv_dy = apply_table(t.grad_y_to_dg1.T, v_loc) / dy
        return du_dx, dv_dy, 0.5 * (du_dy + dv_dx)

    # -- weak-form stress divergence -> CG2 nodal forces ---------------------
    def stress_divergence(self, s11, s22, s12, metric=None):
        """Nodal forces (per unit area): F_n = -int sigma : grad(phi_n) / W_n
        is NOT applied here — returns the raw integrals (Fu, Fv) as HOFields
        (units: stress x length). Metric weighting happens per element
        BEFORE the scatter, so graded meshes assemble consistently.
        ``metric``: optional (dx, dy) full planes (see ``step_consts``)."""
        t = self.tables
        if metric is not None:
            dx, dy = metric
        else:
            dx, dy = self._dx_dy(s11.dtype)
        # int_E sigma_c phi_c dN_n/dx dA = dy * div_x[c, n] (reference-integral
        # times the metric); forces get a minus sign (integration by parts).
        fu_loc = -(
            apply_table(t.div_x, s11) * dy + apply_table(t.div_y, s12) * dx
        )
        fv_loc = -(
            apply_table(t.div_x, s12) * dy + apply_table(t.div_y, s22) * dx
        )
        return self.scatter_local(fu_loc), self.scatter_local(fv_loc)

    def node_weights(self, dtype=jnp.float64, area=None) -> HOField:
        """W_n = int phi_n dA accumulated per owned node (area weights).

        ``area``: optional (nx, ny) element-area plane override — the
        LocalMeshView path (this device's traced block of the global
        areas) passes it from ``step_consts``."""
        if area is None:
            area = jnp.broadcast_to(
                jnp.asarray(self.mesh.cell_area, dtype=dtype),
                (self.mesh.nx, self.mesh.ny),
            )
        contribs = jnp.stack(
            [float(self.tables.lumped_mass[n]) * area for n in range(9)]
        )
        return self.scatter_local(contribs)

    def node_thickness(self, h, area=None) -> HOField:
        """Lumped-mass-weighted ice thickness at nodes: sum(h W)/sum(W)."""
        if area is None:
            area = jnp.asarray(self.mesh.cell_area, dtype=h.dtype)
        contribs = jnp.stack(
            [float(self.tables.lumped_mass[n]) * area * h for n in range(9)]
        )
        num = self.scatter_local(contribs)
        den = self.node_weights(dtype=h.dtype, area=jnp.broadcast_to(area, h.shape))
        return HOField(
            v=num.v / den.v, b=num.b / den.b, l=num.l / den.l, c=num.c / den.c
        )

    def boundary_mask(self, dtype=jnp.float32):
        """Per-plane no-slip masks (1 interior, 0 wall).

        Inside shard_map only the GLOBAL first block's edge row/col is a
        wall (traced via the device's mesh coordinates, cf.
        ``MEVPSolver.boundary_mask``)."""
        nx, ny = self.mesh.nx, self.mesh.ny
        ax_x, ax_y = self.spmd
        # Traced iota construction in ALL modes (outside shard_map
        # is_global_edge is a static True): numpy masks would embed four
        # (nx, ny) literals in the module — 268 MB at 16M elements.
        from .stencil import is_global_edge

        row0 = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 0) == 0
        col0 = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 1) == 0
        masks = {}
        for name in PLANES:
            mask = jnp.ones((nx, ny), dtype=dtype)
            if not self.mesh.periodic_x and name in ("v", "l"):
                mask = jnp.where(row0 & is_global_edge(ax_x, "first"), 0.0, mask)
            if not self.mesh.periodic_y and name in ("v", "b"):
                mask = jnp.where(col0 & is_global_edge(ax_y, "first"), 0.0, mask)
            masks[name] = mask
        return HOField(**masks)

    # -- the mEVP iteration --------------------------------------------------
    def _kernel_choice(self) -> str:
        """'blocked' (shard_map ghost zones) or 'xla'."""
        if self.backend == "blocked" and any(axis is not None for axis in self.spmd):
            # Non-uniform geometry under shard_map must arrive as a
            # LocalMeshView (per-device traced metric planes riding the
            # consts; see MEVPSolver._kernel_choice).
            if not (self.mesh.uniform or self.mesh.is_local_view):
                raise NotImplementedError(
                    "blocked exchange under shard_map needs a uniform "
                    "local mesh or a LocalMeshView of the global mesh"
                )
            return "blocked"
        return "xla"

    def step_consts(self, state: HOVelocityState, h, a, forcing, mask, dt: float):
        """Per-step constant planes shared by the single-device and blocked paths.

        29 planes: element ice strength, plus per CG2 plane k: dt/m, the
        active (mask * has-ice) factor, the constant velocity-update
        numerator b = u_n + (dt/m) tau_a, reciprocal lumped-mass weights,
        and the ocean currents.
        """
        p = self.params
        dtype = state.u.v.dtype
        consts = {
            "strength": p.p_star * h * jnp.exp(-p.c_compaction * (1.0 - a))
        }
        area = None
        if not self.mesh.uniform:
            # Per-element metric planes (the land-mask pattern), so the
            # blocked exchange widens them like any other const.
            # LocalMeshView (shard_map over a non-uniform global mesh):
            # this device's traced block of the global metric —
            # bit-identical at f64 to the static single-device planes.
            if self.mesh.is_local_view:
                m = self.mesh.local_metric(self.spmd, dtype)
                consts["dx"] = m["dx"]
                consts["dy"] = m["dy"]
                consts["inv_dx"] = 1.0 / m["dx"]
                consts["inv_dy"] = 1.0 / m["dy"]
                area = m["area"]
            else:
                # On-device outer products of the 1-D metric factors (no
                # (nx, ny) literals in the module; see mesh.
                # device_metric_planes). Bit-identical at f64.
                from .mesh import device_metric_planes

                m = device_metric_planes(self.mesh, dtype)
                consts["dx"] = m["dx"]
                consts["dy"] = m["dy"]
                consts["inv_dx"] = 1.0 / m["dx"]
                consts["inv_dy"] = 1.0 / m["dy"]
                area = m["area"]
        h_node = self.node_thickness(h, area=area)
        weights = self.node_weights(dtype=dtype, area=area)
        a_node = self.node_thickness(a, area=area) if p.a_weighted_stress else None
        for k in PLANES:
            m = p.rho_ice * getattr(h_node, k)
            dm = dt / jnp.maximum(m, p.min_ice_mass)
            ua = getattr(forcing.u_atm, k)
            va = getattr(forcing.v_atm, k)
            wind = p.rho_atm * p.cd_atm * jnp.sqrt(ua * ua + va * va)
            active = getattr(mask, k) * (m > p.min_ice_mass).astype(dtype)
            wind_w = 1.0
            if a_node is not None:
                # A-weighted surface stresses (see MEVPParams): the lumped
                # nodal concentration scales the wind stress here and the
                # ocean drag in subcycle_body via the a_{k} planes;
                # sub-threshold nodes are pinned via the active factor.
                ak = jnp.clip(getattr(a_node, k), 0.0, 1.0)
                active = active * (ak >= p.a_dyn_min).astype(dtype)
                wind_w = ak
                consts[f"a_{k}"] = ak
            consts[f"dt_m_{k}"] = dm
            consts[f"active_{k}"] = active
            consts[f"b_u_{k}"] = getattr(state.u, k) + dm * wind_w * wind * ua
            consts[f"b_v_{k}"] = getattr(state.v, k) + dm * wind_w * wind * va
            consts[f"inv_w_{k}"] = 1.0 / getattr(weights, k)
            consts[f"u_ocean_{k}"] = getattr(forcing.u_ocean, k)
            consts[f"v_ocean_{k}"] = getattr(forcing.v_ocean, k)
        return consts

    def subcycle_body(self, carry, consts, dt: float):
        """One HO mEVP subcycle — shared by the single-device and blocked
        paths.

        ``carry``: (u: HOField, v: HOField, s11, s22, s12) with stresses as
        (3, nx, ny) dG1 coefficients; ``consts``: see :meth:`step_consts`.
        """
        p = self.params
        t = self.tables
        e2 = p.ellipse * p.ellipse
        alpha, beta = p.alpha, p.beta
        u, v, s11, s22, s12 = carry
        strength = consts["strength"]

        # Gauss-point projection tables with weights/mass folded in.
        proj = (t.phi_dg1 * t.w_vol[None, :]) * (
            1.0 / np.array([1.0, 1 / 12, 1 / 12])
        )[:, None]

        # The strain dG1 round trip stays factored (gradient tables, then
        # phi_dg1): the composed (9, NQ) tables would be dense (2x36 MACs)
        # while this factored pair exploits the projection tables'
        # sparsity (2x19 + 3x12 = 112 total).
        graded = "inv_dx" in consts
        e11, e22, e12 = self.strain_rates(
            u, v,
            metric=(consts["inv_dx"][None], consts["inv_dy"][None])
            if graded else None,
        )

        # VP law at Gauss points, projected back to dG1.
        phi_at_q = t.phi_dg1  # (3, NQ)
        e11_q = apply_table(phi_at_q, e11)
        e22_q = apply_table(phi_at_q, e22)
        e12_q = apply_table(phi_at_q, e12)
        delta_q = jnp.sqrt(
            (e11_q * e11_q + e22_q * e22_q) * (1.0 + 1.0 / e2)
            + 2.0 * e11_q * e22_q * (1.0 - 1.0 / e2)
            + 4.0 / e2 * e12_q * e12_q
        )
        inv_denom = 1.0 / (delta_q + p.delta_min)
        zeta_q = 0.5 * strength[None] * inv_denom
        eta_q = zeta_q * (1.0 / e2)
        p_rep_q = strength[None] * delta_q * inv_denom
        div_q = e11_q + e22_q
        s11_vp_q = 2.0 * eta_q * e11_q + (zeta_q - eta_q) * div_q - 0.5 * p_rep_q
        s22_vp_q = 2.0 * eta_q * e22_q + (zeta_q - eta_q) * div_q - 0.5 * p_rep_q
        s12_vp_q = 2.0 * eta_q * e12_q

        s11_vp = apply_table(proj.T, s11_vp_q)
        s22_vp = apply_table(proj.T, s22_vp_q)
        s12_vp = apply_table(proj.T, s12_vp_q)

        inv_alpha = 1.0 / alpha
        s11 = s11 + (s11_vp - s11) * inv_alpha
        s22 = s22 + (s22_vp - s22) * inv_alpha
        s12 = s12 + (s12_vp - s12) * inv_alpha

        fu_raw, fv_raw = self.stress_divergence(
            s11, s22, s12,
            metric=(consts["dx"], consts["dy"]) if graded else None,
        )

        # u and v at a node share |u_rel| and the drag denominator:
        # compute c_w once per plane and fold the Dirichlet mask into
        # one shared reciprocal (1 divide + 1 sqrt per plane, not 2+2).
        def plane_uv(k):
            uk, vk = getattr(u, k), getattr(v, k)
            uo = consts[f"u_ocean_{k}"]
            vo = consts[f"v_ocean_{k}"]
            rel_u = uo - uk
            rel_v = vo - vk
            c_w = p.rho_ocean * p.cd_ocean * jnp.sqrt(
                rel_u * rel_u + rel_v * rel_v
            )
            if f"a_{k}" in consts:
                # A-weighted ocean stress: tau_w = A c_w (v_w - v).
                c_w = c_w * consts[f"a_{k}"]
            cor_u = p.f_coriolis * (vk - vo) if p.use_coriolis else 0.0
            cor_v = -p.f_coriolis * (uk - uo) if p.use_coriolis else 0.0
            dm = consts[f"dt_m_{k}"]
            inv_w = consts[f"inv_w_{k}"]
            inv_drag = consts[f"active_{k}"] / (1.0 + beta + dm * c_w)
            new_u = (
                beta * uk + consts[f"b_u_{k}"]
                + dm * (getattr(fu_raw, k) * inv_w + c_w * uo) + dt * cor_u
            ) * inv_drag
            new_v = (
                beta * vk + consts[f"b_v_{k}"]
                + dm * (getattr(fv_raw, k) * inv_w + c_w * vo) + dt * cor_v
            ) * inv_drag
            return new_u, new_v

        uv = {k: plane_uv(k) for k in PLANES}
        u_new = HOField(**{k: uv[k][0] for k in PLANES})
        v_new = HOField(**{k: uv[k][1] for k in PLANES})
        return (u_new, v_new, s11, s22, s12)

    def _blocked_subcycles(self, carry0, consts, dt, n_subcycles):
        """Ghost-zone ("temporally blocked") halo exchange under shard_map.

        The HO analogue of ``MEVPSolver._blocked_subcycles``
        : widen all 17 state planes (4+4 CG2 velocity,
        3x3 dG1 stress coefficients) and the 29 constant planes by H ghost
        cells from the neighbor devices (ONE ppermute pair per axis), run
        H subcycles on the widened local block with plain closed-boundary
        shifts, keep the interior, repeat. Per subcycle the gather_local
        (+1 shifts) / scatter_local (-1 shifts) pair invalidates exactly
        one ghost ring, so the interior stays EXACTLY equal to the
        per-subcycle-exchange result; ghost stresses beyond a global wall
        only feed the wall-masked v/l/b planes (Dirichlet), as in CG1.
        """
        from .stencil import halo_widen

        h = self.block_halo
        nx, ny = self.mesh.nx, self.mesh.ny
        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ax_x, ax_y = self.spmd

        def widen(f):
            # Widen the trailing (nx, ny) dims (the stress stacks carry a
            # leading dG1-dof axis).
            f = halo_widen(f, h, f.ndim - 2, px, ax_x)
            return halo_widen(f, h, f.ndim - 1, py, ax_y)

        # A local solver on the widened block: closed shifts, no spmd.
        # Non-uniform geometry (LocalMeshView) travels entirely via the
        # widened metric const planes — subcycle_body keys on the consts,
        # so the shim mesh is a unit uniform mesh then.
        local = MEVPSolverHO(
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
            padded = jax.tree.map(widen, carry)

            def sub(_, c):
                return local.subcycle_body(c, consts_w, dt)

            padded = jax.lax.fori_loop(0, n_sub, sub, padded)
            return jax.tree.map(
                lambda f: f[..., h : h + nx, h : h + ny], padded
            )

        carry = carry0
        remaining = n_subcycles
        while remaining > 0:
            n_sub = min(h, remaining)
            remaining -= n_sub
            carry = round_body(carry, n_sub)
        return carry

    @partial(jax.jit, static_argnames=("self", "dt", "n_subcycles"))
    def step(
        self,
        state: HOVelocityState,
        h,  # effective ice thickness per element (nx, ny)
        a,  # concentration per element (nx, ny)
        forcing: HODynamicsForcing,
        mask: HOField,
        dt: float,
        n_subcycles: int = 100,
    ) -> HOVelocityState:
        consts = self.step_consts(state, h, a, forcing, mask, dt)
        carry0 = (state.u, state.v, state.s11, state.s22, state.s12)
        if self._kernel_choice() == "blocked":
            carry = self._blocked_subcycles(carry0, consts, dt, n_subcycles)
        else:
            def subcycle(_, c):
                return self.subcycle_body(c, consts, dt)

            carry = jax.lax.fori_loop(0, n_subcycles, subcycle, carry0)
        u, v, s11, s22, s12 = carry
        return HOVelocityState(u=u, v=v, s11=s11, s22=s22, s12=s12)
