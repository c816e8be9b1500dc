"""Discontinuous-Galerkin tracer transport.

Solves d(psi)/dt + div(v psi) = 0 per tracer with dG0/dG1/dG2 elements and
upwind edge fluxes, SSP-RK time stepping (north-star capability; cf.
BASELINE.json "DG transport ... upwind edge-flux integrals over element
faces").

Array formulation: tracer coefficients live in ``(K, nx, ny)`` arrays;
the semi-discrete RHS is

    dpsi_k/dt = M_k^-1 [ V_k  -  E_k ]
    V_k = sum_q w_q [ (vx_q/dx) dphi_k/dxi + (vy_q/dy) dphi_k/deta ] psi(x_q)
    E_k = (1/dx) (phi_k|_{x=1} . G_{i+1/2} - phi_k|_{x=0} . G_{i-1/2}) + (y)

with ``G`` the upwinded normal-flux integrals on shared faces. Everything is
a contraction over the tiny dof/quad dims (<= 6 x 9) batched over the grid —
pure elementwise work plus one-element neighbor shifts, which XLA fuses;
the diagonal mass matrix avoids any per-element solve.

Velocities enter pre-sampled at quadrature points (``QuadVelocity``), so the
same operator serves analytic benchmark velocities and the CG velocity of
the mEVP solver.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .dgbasis import DGBasis, dg_basis
from .mesh import RectMesh


def _pytree(cls):
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )


def apply_table(table, arr):
    """Contract a tiny static (K, Q) table with (K, nx, ny) -> (Q, nx, ny).

    Unrolled into scalar-weighted elementwise adds that XLA fuses with
    their neighbors. An einsum here would lower to a dot_general whose
    3-6 wide contraction leaves a matrix unit almost idle, and it would
    break the fusion. Zero entries are skipped at trace time (the DG
    tables are sparse).
    """
    table = np.asarray(table)
    n_in, n_out = table.shape
    outs = []
    for q in range(n_out):
        acc = None
        for k in range(n_in):
            c = float(table[k, q])
            if c == 0.0:
                continue
            term = arr[k] if c == 1.0 else c * arr[k]
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else jnp.zeros_like(arr[0]))
    return jnp.stack(outs)


def face_masks_from_land(ocean_mask, periodic_x=False, periodic_y=False, spmd=(None, None)):
    """Impermeable-face masks from an element ocean mask (1=ocean, 0=land).

    A face carries flux only if BOTH adjacent elements are ocean. Returns
    (face_x, face_y) each (nx, ny) in owned-edge layout, multiplying the
    upwind flux arrays.
    """
    from .stencil import shift_m

    left = shift_m(ocean_mask, 0, periodic_x, spmd[0])
    below = shift_m(ocean_mask, 1, periodic_y, spmd[1])
    return ocean_mask * left, ocean_mask * below


@_pytree
@dataclass(frozen=True)
class QuadVelocity:
    """Velocity sampled at DG quadrature points, owned-edge layout.

    vx_vol/vy_vol: (NQ, nx, ny) at volume points;
    vn_x: (NE, nx, ny) normal (+x) velocity at the LEFT face of element i
    (the face between elements i-1 and i); the right domain-boundary face is
    implicit — zero flux when closed, wrap when periodic;
    vn_y: (NE, nx, ny) normal (+y) velocity at the BOTTOM face, analogous.
    """

    vx_vol: jax.Array
    vy_vol: jax.Array
    vn_x: jax.Array
    vn_y: jax.Array


def sample_velocity(mesh: RectMesh, basis: DGBasis, fn: Callable, dtype=jnp.float32) -> QuadVelocity:
    """Sample an analytic velocity fn(x, y) -> (vx, vy) at quadrature points."""
    xv, yv = mesh.volume_quad_coords(basis.xq_vol, basis.yq_vol)
    vx_vol, vy_vol = fn(xv, yv)
    xe, ye = mesh.edge_x_coords(basis.s_edge)
    vnx, _ = fn(xe, ye)
    xh, yh = mesh.edge_y_coords(basis.s_edge)
    _, vny = fn(xh, yh)
    as_a = lambda a: jnp.asarray(np.asarray(a), dtype=dtype)
    return QuadVelocity(
        vx_vol=as_a(vx_vol),
        vy_vol=as_a(vy_vol),
        # Owned edges: faces 0..nx-1 (left faces); the domain's rightmost
        # face is dropped (wall when closed, duplicate of face 0 if periodic).
        vn_x=as_a(np.moveaxis(vnx[: mesh.nx], 2, 0)),
        vn_y=as_a(np.moveaxis(vny[:, : mesh.ny], 2, 0)),
    )


def velocity_from_cg(mesh: RectMesh, basis: DGBasis, u, v, spmd=(None, None)) -> QuadVelocity:
    """Sample a CG1 nodal velocity at quad points (owned-node layout).

    ``u, v`` are (nx, ny) owned-node arrays (see dynamics.stencil); bilinear
    interpolation within each element, single-valued on shared faces.
    ``spmd``: mesh axis names when called inside shard_map.
    """
    from .stencil import shift_p

    px, py = mesh.periodic_x, mesh.periodic_y
    ax_x, ax_y = spmd
    # Quadrature coordinates enter as PYTHON floats in statically unrolled
    # per-point sums (not as jnp constant vectors): scalar-weighted adds
    # that XLA fuses, with no captured array constants.
    xq = [float(x) for x in np.asarray(basis.xq_vol)]
    yq = [float(y) for y in np.asarray(basis.yq_vol)]
    se = [float(s) for s in np.asarray(basis.s_edge)]

    def bilinear(f):
        f00 = f
        f10 = shift_p(f, 0, px, ax_x)
        f01 = shift_p(f, 1, py, ax_y)
        f11 = shift_p(f10, 1, py, ax_y)
        return jnp.stack([
            f00 * ((1 - x) * (1 - y)) + f10 * (x * (1 - y))
            + f01 * ((1 - x) * y) + f11 * (x * y)
            for x, y in zip(xq, yq)
        ])

    vx_vol = bilinear(u)
    vy_vol = bilinear(v)
    # Left face of element i: linear in y between nodes (i, j) and (i, j+1).
    u_up = shift_p(u, 1, py, ax_y)
    v_right = shift_p(v, 0, px, ax_x)
    vn_x = jnp.stack([u * (1 - s) + u_up * s for s in se])  # (NE, nx, ny)
    vn_y = jnp.stack([v * (1 - s) + v_right * s for s in se])
    return QuadVelocity(vx_vol=vx_vol, vy_vol=vy_vol, vn_x=vn_x, vn_y=vn_y)


def cfl_substeps(
    qv: "QuadVelocity", dt, mesh: RectMesh, degree: int,
    k_floor: int = 1, k_max: int = 64, spmd=(None, None),
):
    """Traced transport substep count from the advective CFL number.

    The explicit RK-DG upwind scheme is stable for
    ``nu = (|vx|/dx + |vy|/dy) dt_sub <= ~1/(2p+1)``; this returns
    ``k = ceil(nu / C)`` (C safety-factored) so ``dt/k`` substeps are
    stable for the CURRENT velocity — a cheap max-reduction per step
    instead of a hand-tuned ``transport_substeps``. Conservative form:
    global max speed against the smallest element. Under shard_map the
    max rides a ``pmax`` so every device agrees on the trip count.
    """
    # Cockburn & Shu's RKDG bound: CFL <= 1/(2p+1) for P^p with RK(p+1).
    # 15% safety margin (the Zhang-Shu positivity limiter adds robustness
    # at fronts; validated by the 2000-step wind-8 finiteness test).
    c_stab = 0.85 / (2 * degree + 1)
    # The METRIC widths (mesh.dx, not dx_array): on spherical meshes the
    # zonal width carries cos(phi) and the poleward rows are the tightest.
    # LocalMeshView: the GLOBAL minimum (static, every device agrees) —
    # conservative for any block, and identical to what the single-device
    # run uses.
    geo = mesh.global_mesh if mesh.is_local_view else mesh
    dx_min = float(np.min(np.asarray(geo.dx)))
    dy_min = float(np.min(np.asarray(geo.dy)))
    speed_x = jnp.maximum(
        jnp.max(jnp.abs(qv.vx_vol)), jnp.max(jnp.abs(qv.vn_x))
    )
    speed_y = jnp.maximum(
        jnp.max(jnp.abs(qv.vy_vol)), jnp.max(jnp.abs(qv.vn_y))
    )
    nu = (speed_x / dx_min + speed_y / dy_min) * dt
    for axis in spmd:
        if axis is not None:
            nu = jax.lax.pmax(nu, axis)
    k = jnp.ceil(nu / c_stab).astype(jnp.int32)
    return jnp.clip(jnp.maximum(k, k_floor), 1, k_max)


class DGTransport:
    """The transport operator for one mesh + DG degree + time scheme.

    ``spmd=(x_axis, y_axis)``: mesh axis names when running inside
    ``shard_map`` over a device mesh — neighbor access then halo-exchanges
    block edges via ``ppermute`` (see dynamics.stencil). ``mesh`` describes
    the LOCAL block shape in that case.
    """

    def __init__(
        self, mesh: RectMesh, degree: int = 1, scheme: str = None,
        spmd=(None, None), tvb_m: float = None,
    ) -> None:
        self.mesh = mesh
        self.basis = dg_basis(degree)
        self.spmd = tuple(spmd)
        #: TVB constant M of the minmod slope limiter (None = positivity
        #: limiting only; 0.0 = pure TVD minmod). See ``limit_slopes``.
        self.tvb_m = tvb_m
        #: SSP-RK order matched to spatial order by default (nextsimdg-style).
        self.scheme = scheme or {0: "rk1", 1: "rk2", 2: "rk3"}[degree]
        b = self.basis
        # Static numpy tables, unroll-contracted elementwise (see apply_table).
        self._psi_vol = b.psi_vol
        # Quadrature weights and metric folded into the gradient tables.
        self._wgx_vol = b.w_vol[None, :] * b.dpsi_dx_vol
        self._wgy_vol = b.w_vol[None, :] * b.dpsi_dy_vol
        self._psi_x0 = b.psi_x0
        self._psi_x1 = b.psi_x1
        self._psi_y0 = b.psi_y0
        self._psi_y1 = b.psi_y1
        # Edge weights folded into the face-assembly tables.
        self._wa_x0 = b.psi_x0 * b.w_edge[None, :]
        self._wa_x1 = b.psi_x1 * b.w_edge[None, :]
        self._wa_y0 = b.psi_y0 * b.w_edge[None, :]
        self._wa_y1 = b.psi_y1 * b.w_edge[None, :]
        self._inv_mass = b.inv_mass_diag
        # All candidate-extremum evaluation points for the limiter in one
        # table: volume points + the four faces' quadrature points.
        self._limit_table = np.concatenate(
            [b.psi_vol, b.psi_x0, b.psi_x1, b.psi_y0, b.psi_y1], axis=1
        )

    def metric_planes(self, dtype):
        """Full per-element metric planes for non-uniform meshes.

        None when uniform. 5 planes (the land-mask pattern): inverse
        element widths for the volume gradients, owned-face lengths for
        the flux integrals, inverse cell areas for the edge terms.
        """
        if self.mesh.uniform:
            return None
        if self.mesh.is_local_view:
            # This device's traced block of the global metric (shard_map;
            # NOT cached — the planes embed lax.axis_index). Derived in
            # dtype from f64 factors: bit-identical to the static planes
            # at f64.
            m = self.mesh.local_metric(self.spmd, dtype)
            return {
                "inv_dx": 1.0 / m["dx"],
                "inv_dy": 1.0 / m["dy"],
                "face_x": m["face_x"],
                "face_y": m["face_y"],
                "inv_area": 1.0 / m["area"],
            }
        # On-device outer products of the 1-D metric factors — NOT
        # (nx, ny) numpy literals, which bloat the compiled module by
        # ~n_planes x nx x ny x 4 bytes. Bit-identical at f64.
        from .mesh import device_metric_planes

        m = device_metric_planes(self.mesh, dtype)
        return {
            "inv_dx": 1.0 / m["dx"],
            "inv_dy": 1.0 / m["dy"],
            "face_x": m["face_x"],
            "face_y": m["face_y"],
            "inv_area": 1.0 / m["area"],
        }

    # -- semi-discrete RHS ---------------------------------------------------
    def rhs(self, psi, vel: QuadVelocity, face_masks=None):
        """d(psi)/dt for coefficients psi (K, ..., nx, ny).

        Extra middle dims batch multiple tracers through one pass (the
        velocity arrays are shared — cheaper than one call per tracer).
        ``face_masks``: optional (face_x, face_y) land masks (see
        face_masks_from_land) zeroing fluxes through coastlines.
        """
        mesh = self.mesh
        dtype = psi.dtype
        metric = self.metric_planes(dtype)
        # Broadcast the velocity arrays over any batched tracer dims.
        extra = psi.ndim - 3
        expand = (slice(None),) + (None,) * extra
        vx_vol = vel.vx_vol[expand]
        vy_vol = vel.vy_vol[expand]
        vn_x = vel.vn_x[expand]
        vn_y = vel.vn_y[expand]
        x_axis, y_axis = psi.ndim - 2, psi.ndim - 1

        # Volume term, STREAMED over quadrature points: materializing
        # psi(q)/flux(q) for all NQ points at once costs ~2(NQ x batch)
        # live planes. Accumulating per point keeps the live set at ~2K
        # accumulators + 3 temporaries (bit-identical sums: same
        # ascending-q order, zeros skipped, as the table contraction).
        inv_dx = 1.0 / mesh.dx if metric is None else metric["inv_dx"]
        inv_dy = 1.0 / mesh.dy if metric is None else metric["inv_dy"]
        psi_tab = np.asarray(self._psi_vol)
        wgx_t = np.asarray(self._wgx_vol.T)  # (NQ, K)
        wgy_t = np.asarray(self._wgy_vol.T)
        n_dofs, n_q = psi_tab.shape
        acc_x = [None] * n_dofs
        acc_y = [None] * n_dofs
        for q in range(n_q):
            pq = None
            for k in range(n_dofs):
                c = float(psi_tab[k, q])
                if c == 0.0:
                    continue
                term = psi[k] if c == 1.0 else c * psi[k]
                pq = term if pq is None else pq + term
            fx = vx_vol[(q,) + (slice(None),) * extra] * pq
            fy = vy_vol[(q,) + (slice(None),) * extra] * pq
            for k in range(n_dofs):
                cx = float(wgx_t[q, k])
                if cx != 0.0:
                    t = fx if cx == 1.0 else cx * fx
                    acc_x[k] = t if acc_x[k] is None else acc_x[k] + t
                cy = float(wgy_t[q, k])
                if cy != 0.0:
                    t = fy if cy == 1.0 else cy * fy
                    acc_y[k] = t if acc_y[k] is None else acc_y[k] + t
        zero = jnp.zeros(psi.shape[1:], dtype)
        gx = jnp.stack([a if a is not None else zero for a in acc_x])
        gy = jnp.stack([a if a is not None else zero for a in acc_y])
        volume = gx * inv_dx + gy * inv_dy

        # Upwind edge fluxes, x-direction (owned left-face edges).
        from .stencil import is_global_edge, shift_m, shift_p

        px, py = mesh.periodic_x, mesh.periodic_y
        ax_x, ax_y = self.spmd
        tr_x1 = apply_table(self._psi_x1, psi)  # right-face traces
        tr_x0 = apply_table(self._psi_x0, psi)  # left-face traces
        # Face i sits between elements i-1 (left) and i (right).
        left_of_edge = shift_m(tr_x1, x_axis, px, ax_x)
        upwinded = jnp.where(vn_x >= 0, left_of_edge, tr_x0)
        g_x = vn_x * upwinded  # edge weights live in the assembly tables
        if not px:
            # Closed domain: the global i=0 face is an impermeable wall.
            # (iota-based select, not a mask buffer: runs identically on
            # one device and under shard_map.)
            face0 = jax.lax.broadcasted_iota(jnp.int32, g_x.shape, x_axis) == 0
            g_x = jnp.where(face0 & is_global_edge(ax_x, "first"), 0.0, g_x)
        # Element i's faces: left = g_x[i], right = g_x[i+1] (wrap/zero-wall).
        if face_masks is not None:
            g_x = g_x * face_masks[0]
        if metric is not None:
            # Scale by the owned face's metric length BEFORE the neighbor
            # shift: both sides of a shared face then integrate the same
            # length * flux, which keeps curvilinear meshes conservative.
            g_x = g_x * metric["face_x"]
        g_right = shift_p(g_x, x_axis, px, ax_x)
        edge_x = (
            apply_table(self._wa_x1.T, g_right) - apply_table(self._wa_x0.T, g_x)
        )
        if metric is None:
            edge_x = edge_x / mesh.dx
        else:
            edge_x = edge_x * metric["inv_area"]

        # Upwind edge fluxes, y-direction (owned bottom-face edges).
        tr_y1 = apply_table(self._psi_y1, psi)  # top-face traces
        tr_y0 = apply_table(self._psi_y0, psi)  # bottom
        below = shift_m(tr_y1, y_axis, py, ax_y)
        upwinded_y = jnp.where(vn_y >= 0, below, tr_y0)
        g_y = vn_y * upwinded_y
        if not py:
            face0 = jax.lax.broadcasted_iota(jnp.int32, g_y.shape, y_axis) == 0
            g_y = jnp.where(face0 & is_global_edge(ax_y, "first"), 0.0, g_y)
        if face_masks is not None:
            g_y = g_y * face_masks[1]
        if metric is not None:
            # Zonal faces carry their own latitude-line length (cos(phi_j)
            # on a sphere): a constant northward flow correctly converges.
            g_y = g_y * metric["face_y"]
        g_top = shift_p(g_y, y_axis, py, ax_y)
        edge_y = (
            apply_table(self._wa_y1.T, g_top) - apply_table(self._wa_y0.T, g_y)
        )
        if metric is None:
            edge_y = edge_y / mesh.dy
        else:
            edge_y = edge_y * metric["inv_area"]

        rhs = volume - edge_x - edge_y
        inv_mass = self._inv_mass
        return jnp.stack([float(inv_mass[k]) * rhs[k] for k in range(len(inv_mass))])

    # -- positivity limiting (Zhang & Shu) -----------------------------------
    def limit_positivity(self, psi):
        """Scale higher DG moments so pointwise values stay >= 0.

        Zhang-Shu-type linear scaling about the (conserved, assumed
        nonnegative) cell mean: evaluates the polynomial at the volume
        quadrature points and all face quadrature points, and shrinks the
        deviation from the mean by theta = min(1, mean / (mean - min)).
        Conservative (the mean is untouched) and a no-op where the minimum
        is already nonnegative.
        """
        if self.basis.n_dofs == 1:
            return psi
        mean = psi[0]
        if self.basis.n_dofs == 3:
            # dG1: the polynomial is linear, so its TRUE minimum over the
            # element is at a corner: mean - (|s1| + |s2|)/2. Cheaper than
            # streaming 12+ evaluation points AND a stronger guarantee
            # (pointwise positivity everywhere, not just at quadrature
            # points).
            mins = mean - 0.5 * (jnp.abs(psi[1]) + jnp.abs(psi[2]))
            deficit = mean - mins
            theta = jnp.where(
                mins < 0.0,
                jnp.clip(mean / jnp.where(deficit > 0, deficit, 1.0), 0.0, 1.0),
                1.0,
            )
            return jnp.concatenate([mean[None], psi[1:] * theta[None]], axis=0)
        # Streamed min over the evaluation points (the full (Q, ...) value
        # table would be the largest live intermediate).
        table = np.asarray(self._limit_table)
        n_dofs, n_pts = table.shape
        mins = None
        for q in range(n_pts):
            value = None
            for k in range(n_dofs):
                c = float(table[k, q])
                if c == 0.0:
                    continue
                term = psi[k] if c == 1.0 else c * psi[k]
                value = term if value is None else value + term
            if value is None:
                value = jnp.zeros_like(mean)
            mins = value if mins is None else jnp.minimum(mins, value)
        deficit = mean - mins  # > 0 when the polynomial dips below the mean
        theta = jnp.where(
            mins < 0.0,
            jnp.clip(mean / jnp.where(deficit > 0, deficit, 1.0), 0.0, 1.0),
            1.0,
        )
        return jnp.concatenate([mean[None], psi[1:] * theta[None]], axis=0)

    # -- TVB slope limiting (Cockburn & Shu) ----------------------------------
    def limit_slopes(self, psi):
        """TVB minmod slope limiter on the linear moments (dG1/dG2).

        The Zhang-Shu positivity limiter guarantees psi >= 0 but not
        monotonicity — sharp fronts at dG1/dG2 still ring. This is the
        classical TVB-modified minmod of Cockburn & Shu: each linear
        moment is compared against the forward/backward cell-mean
        differences (for a smooth linear field psi1 == both differences,
        so exact linears are untouched),

            psi1' = minmod(psi1, mean_{i+1}-mean_i, mean_i-mean_{i-1}),

        EXCEPT where |psi1| <= M dx^2 (the TVB tolerance: genuine smooth
        extrema are left at full order; ``tvb_m`` = M, 0 = pure TVD).
        Where a linear moment was actually cut, the element's quadratic
        moments are zeroed (the polynomial falls back to the limited P1 —
        the standard hierarchical-limiter behavior). Cell means are never
        touched, so conservation is exact. Closed walls use zero-gradient
        ghost means (one-sided differences clamp to 0 there).
        """
        if self.tvb_m is None or self.basis.n_dofs == 1:
            return psi
        from .stencil import is_global_edge, shift_m, shift_p

        mesh = self.mesh
        dtype = psi.dtype
        px, py = mesh.periodic_x, mesh.periodic_y
        ax_x, ax_y = self.spmd
        mean = psi[0]
        x_axis, y_axis = mean.ndim - 2, mean.ndim - 1

        def deltas(axis, periodic, axis_name):
            d_fwd = shift_p(mean, axis, periodic, axis_name) - mean
            d_bwd = mean - shift_m(mean, axis, periodic, axis_name)
            if not periodic:
                # Zero-gradient ghosts at the global walls (the zero-filled
                # shifts would otherwise fabricate a -mean jump there).
                n = mean.shape[axis]
                idx = jax.lax.broadcasted_iota(jnp.int32, mean.shape, axis)
                d_fwd = jnp.where(
                    (idx == n - 1) & is_global_edge(axis_name, "last"),
                    0.0, d_fwd,
                )
                d_bwd = jnp.where(
                    (idx == 0) & is_global_edge(axis_name, "first"),
                    0.0, d_bwd,
                )
            return d_fwd, d_bwd

        def minmod3(a, b, c):
            same = (jnp.sign(a) == jnp.sign(b)) & (jnp.sign(a) == jnp.sign(c))
            m = jnp.sign(a) * jnp.minimum(jnp.abs(a), jnp.minimum(jnp.abs(b), jnp.abs(c)))
            return jnp.where(same, m, 0.0)

        # TVB tolerance M dx^2 (physical widths; per-element on graded meshes;
        # LocalMeshView: this device's traced block of the global widths).
        from .mevp import _metric

        if mesh.is_local_view:
            m = mesh.local_metric(self.spmd, dtype)
            dx, dy = m["dx"], m["dy"]
        else:
            dx = _metric(mesh.dx, dtype)
            dy = _metric(mesh.dy, dtype)
        tol_x = self.tvb_m * dx * dx
        tol_y = self.tvb_m * dy * dy

        dpx, dmx = deltas(x_axis, px, ax_x)
        dpy, dmy = deltas(y_axis, py, ax_y)
        s1 = jnp.where(
            jnp.abs(psi[1]) <= tol_x, psi[1], minmod3(psi[1], dpx, dmx)
        )
        s2 = jnp.where(
            jnp.abs(psi[2]) <= tol_y, psi[2], minmod3(psi[2], dpy, dmy)
        )
        if self.basis.n_dofs == 3:
            return jnp.stack([mean, s1, s2])
        # dG2: where a linear moment was cut, drop to the limited P1.
        eps = jnp.asarray(1e-12, dtype)
        cut = (jnp.abs(s1 - psi[1]) > eps) | (jnp.abs(s2 - psi[2]) > eps)
        keep = jnp.where(cut, 0.0, 1.0)
        return jnp.stack(
            [mean, s1, s2, psi[3] * keep, psi[4] * keep, psi[5] * keep]
        )

    # -- SSP-RK time stepping ------------------------------------------------
    def step(self, psi, vel: QuadVelocity, dt, limit: bool = False, face_masks=None):
        """One SSP-RK step; ``limit`` applies the positivity limiter after
        every RK stage (SSP keeps the limited property through the convex
        combinations). When ``tvb_m`` is configured, the TVB slope limiter
        runs before the positivity limiter at every stage."""
        if limit and self.tvb_m is not None:
            lim = lambda p: self.limit_positivity(self.limit_slopes(p))
        elif limit:
            lim = self.limit_positivity
        else:
            lim = lambda p: p
        rhs = lambda p: self.rhs(p, vel, face_masks)
        if self.scheme == "rk1":
            return lim(psi + dt * rhs(psi))
        if self.scheme == "rk2":
            psi1 = lim(psi + dt * rhs(psi))
            return lim(0.5 * psi + 0.5 * (psi1 + dt * rhs(psi1)))
        if self.scheme == "rk3":
            psi1 = lim(psi + dt * rhs(psi))
            psi2 = lim(0.75 * psi + 0.25 * (psi1 + dt * rhs(psi1)))
            return lim(psi / 3.0 + 2.0 / 3.0 * (psi2 + dt * rhs(psi2)))
        raise ValueError(f"unknown scheme {self.scheme}")

    @partial(jax.jit, static_argnames=("self", "n_steps"))
    def run(self, psi, vel: QuadVelocity, dt, n_steps: int):
        """n_steps on device via lax.scan."""

        def body(p, _):
            return self.step(p, vel, dt), None

        out, _ = jax.lax.scan(body, psi, None, length=n_steps)
        return out

    # -- setup helpers -------------------------------------------------------
    def project(self, fn, dtype=jnp.float32):
        """L2-project an analytic field onto DG coefficients (K, nx, ny).

        The projection lives in reference coordinates, so the element metric
        cancels — this works unchanged on graded meshes.
        """
        b = self.basis
        x, y = self.mesh.volume_quad_coords(b.xq_vol, b.yq_vol)
        values = np.broadcast_to(fn(x, y), (len(b.w_vol), self.mesh.nx, self.mesh.ny))
        coeffs = np.einsum("q,kq,qxy->kxy", b.w_vol, b.psi_vol, values)
        coeffs = coeffs / b.mass_diag[:, None, None]
        return jnp.asarray(coeffs, dtype=dtype)

    def total_mass(self, psi):
        """Integral of the tracer over the domain (cell means x areas)."""
        return jnp.sum(psi[0] * jnp.asarray(self.mesh.cell_area, dtype=psi.dtype))
