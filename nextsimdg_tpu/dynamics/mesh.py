"""Structured meshes for the dynamical core.

Beyond-snapshot component (SURVEY.md section 2.3/7.3): the reference's only
grid is a fixed 10x10 ``DevGrid``; the dynamics needs a parametric mesh
with geometry. Three geometries:

* uniform rectangular;
* tensor-graded (variable resolution): ``dx`` a per-column array, ``dy``
  per-row — regionally refined pan-Arctic-style grids;
* spherical lon-lat (:class:`SphericalMesh`): logical (i, j) =
  (longitude, latitude) with the zonal metric factor cos(phi) — element
  widths shrink poleward, zonal faces carry their own latitude's length,
  and element areas are the exact spherical-zone areas.

The transport/momentum solvers consume only the metric interface
(``dx``/``dy`` for in-element gradients, ``face_len_x``/``face_len_y`` for
shared-face flux lengths, ``cell_area``), so all three geometries run the
same solver code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np

Spacing = Union[float, tuple, np.ndarray]


def _as_spacing(value, count: int) -> np.ndarray:
    arr = np.asarray(value, dtype=np.float64).reshape(-1)
    if arr.size == 1:
        arr = np.full(count, float(arr[0]))
    if arr.size != count:
        raise ValueError(f"spacing has {arr.size} entries, expected {count}")
    return arr


class RectMesh:
    """nx x ny elements; dx per column / dy per row (scalars broadcast).

    ``periodic_x/periodic_y`` select wrap-around vs closed (no-flux /
    no-slip) boundaries.
    """

    #: True on :class:`LocalMeshView` — the per-device block of a
    #: non-uniform global mesh under shard_map, whose metric is traced
    #: (sliced by device coordinates) rather than static.
    is_local_view = False

    def __init__(
        self, nx: int, ny: int, dx: Spacing, dy: Spacing,
        x0: float = 0.0, y0: float = 0.0,
        periodic_x: bool = False, periodic_y: bool = False,
    ) -> None:
        self.nx = int(nx)
        self.ny = int(ny)
        self._dx = _as_spacing(dx, self.nx)
        self._dy = _as_spacing(dy, self.ny)
        self.uniform = bool(
            np.all(self._dx == self._dx[0]) and np.all(self._dy == self._dy[0])
        )
        self.x0 = float(x0)
        self.y0 = float(y0)
        self.periodic_x = bool(periodic_x)
        self.periodic_y = bool(periodic_y)
        # Node positions (left/bottom edges of each element column/row).
        self._xn = self.x0 + np.concatenate([[0.0], np.cumsum(self._dx)])
        self._yn = self.y0 + np.concatenate([[0.0], np.cumsum(self._dy)])

    # Solvers close over mesh objects as static jit arguments.
    def __hash__(self) -> int:
        return hash((
            self.nx, self.ny, self.x0, self.y0, self.periodic_x, self.periodic_y,
            self._dx.tobytes(), self._dy.tobytes(),
        ))

    def __eq__(self, other) -> bool:
        return isinstance(other, RectMesh) and hash(self) == hash(other)

    # -- spacing accessors ---------------------------------------------------
    @property
    def dx(self):
        """Scalar spacing when uniform; (nx, 1) per-column widths otherwise."""
        return float(self._dx[0]) if self.uniform else self._dx[:, None]

    @property
    def dy(self):
        return float(self._dy[0]) if self.uniform else self._dy[None, :]

    @property
    def dx_array(self) -> np.ndarray:
        return self._dx

    @property
    def dy_array(self) -> np.ndarray:
        return self._dy

    @property
    def cell_area(self):
        """Element areas: scalar (uniform) or broadcastable to (nx, ny)."""
        if self.uniform:
            return float(self._dx[0] * self._dy[0])
        return self._dx[:, None] * self._dy[None, :]

    # -- face metric (shared-face flux lengths) -------------------------------
    # The left (x) face of element (i, j) and the bottom (y) face are the
    # OWNED faces; neighbors read them via shifts, so both sides of a shared
    # face see the same length and face-flux exchange is conservative.
    @property
    def face_len_x(self):
        """Length of the left face of element (i, j); broadcastable."""
        return float(self._dy[0]) if self.uniform else self._dy[None, :]

    @property
    def face_len_y(self):
        """Length of the bottom face of element (i, j); broadcastable."""
        return float(self._dx[0]) if self.uniform else self._dx[:, None]

    # -- separable metric factors ---------------------------------------------
    # Every metric plane of the tensor-product geometries (graded rectangles
    # AND lon-lat spheres) factors as col(x)[:, None] * row(y)[None, :].
    # This is the slicing primitive that lets shard_map devices fetch THEIR
    # block of the global metric from two tiny 1-D arrays (LocalMeshView)
    # instead of replicating (nx, ny) planes.
    def metric_factors(self):
        """(col (nx,), row (ny,)) f64 factor pairs per metric plane:
        ``dx``/``dy`` (element widths), ``area`` (element areas),
        ``face_x``/``face_y`` (owned-face lengths)."""
        ones_x = np.ones(self.nx)
        ones_y = np.ones(self.ny)
        return {
            "dx": (self._dx, ones_y),
            "dy": (ones_x, self._dy),
            "area": (self._dx, self._dy),
            "face_x": (ones_x, self._dy),
            "face_y": (self._dx, ones_y),
        }

    @property
    def n_elements(self) -> int:
        return self.nx * self.ny

    @property
    def lx(self) -> float:
        return float(self._dx.sum())

    @property
    def ly(self) -> float:
        return float(self._dy.sum())

    def element_centers(self):
        """(x, y) arrays of element centers, each (nx, ny)."""
        x = self._xn[:-1] + 0.5 * self._dx
        y = self._yn[:-1] + 0.5 * self._dy
        return np.meshgrid(x, y, indexing="ij")

    def node_coords(self):
        """(x, y) arrays of CG1 node coordinates, each (nx+1, ny+1)."""
        return np.meshgrid(self._xn, self._yn, indexing="ij")

    def edge_x_coords(self, s_edge):
        """Coordinates of vertical-edge quadrature points: (nx+1, ny, NE)."""
        ex = self._xn
        ey = self._yn[:-1][:, None] + s_edge[None, :] * self._dy[:, None]
        x = np.broadcast_to(ex[:, None, None], (self.nx + 1, self.ny, len(s_edge)))
        y = np.broadcast_to(ey[None, :, :], (self.nx + 1, self.ny, len(s_edge)))
        return x, y

    def edge_y_coords(self, s_edge):
        """Coordinates of horizontal-edge quadrature points: (nx, ny+1, NE)."""
        ex = self._xn[:-1][:, None] + s_edge[None, :] * self._dx[:, None]
        ey = self._yn
        x = np.broadcast_to(ex[:, None, :], (self.nx, self.ny + 1, len(s_edge)))
        y = np.broadcast_to(ey[None, :, None], (self.nx, self.ny + 1, len(s_edge)))
        return x, y

    def volume_quad_coords(self, xq_vol, yq_vol):
        """Coordinates of volume quadrature points: each (NQ, nx, ny)."""
        x = self._xn[:-1][None, :, None] + xq_vol[:, None, None] * self._dx[None, :, None]
        y = self._yn[:-1][None, None, :] + yq_vol[:, None, None] * self._dy[None, None, :]
        x = np.broadcast_to(x, (len(xq_vol), self.nx, self.ny))
        y = np.broadcast_to(y, (len(yq_vol), self.nx, self.ny))
        return x, y


def device_metric_planes(mesh: "RectMesh", dtype) -> dict:
    """The mesh's metric planes as ON-DEVICE outer products of the 1-D
    separable factors (:meth:`RectMesh.metric_factors`).

    Materializing ``np.broadcast_to(mesh.dx, (nx, ny))`` embeds an
    (nx, ny) LITERAL per plane in the compiled module — a 16M-element
    spherical mesh carries ~500 MB of broadcast constants, which waste
    device memory and compile time. Two (nx,)/(ny,) constants plus one
    runtime multiply replace each literal; at f64 the products are
    bit-identical to the numpy-broadcast planes (same IEEE multiplies),
    so the exactness tests are unaffected.

    Returns dict(dx, dy, area, face_x, face_y) of (nx, ny) arrays.
    """
    import jax.numpy as jnp

    out = {}
    for name, (col, row) in mesh.metric_factors().items():
        out[name] = (
            jnp.asarray(col, dtype)[:, None] * jnp.asarray(row, dtype)[None, :]
        )
    return out


#: mean Earth radius [m], as used by ERA5/CF tooling.
EARTH_RADIUS = 6.371e6


class SphericalMesh(RectMesh):
    """Regular lon-lat mesh on the sphere: i ~ longitude, j ~ latitude.

    Metric treatment (piecewise-constant per element / per face):

    * in-element gradients use the element-center widths
      ``dx = R cos(phi_c) dlambda`` (a (1, ny) plane) and ``dy = R dphi``;
    * the zonal (bottom) face of element (i, j) has its OWN latitude's
      length ``R cos(phi_j) dlambda``, shared exactly with the (i, j-1)
      neighbor — face fluxes are conservative and a constant meridional
      velocity correctly converges poleward (the cos(phi) divergence);
    * element areas are the exact zone areas
      ``R^2 dlambda (sin(phi_{j+1}) - sin(phi_j))``.

    Curvature (tan(phi)/R) terms in the velocity-gradient tensor are
    neglected — O(dy/R) relative error, <1% for regional Arctic domains.
    Logical coordinates (``element_centers`` etc.) are arc lengths
    ``x = R*lambda``, ``y = R*phi``; ``lonlat_centers()`` gives degrees.
    """

    def __init__(
        self, nx: int, ny: int, lon0: float, lon1: float,
        lat0: float, lat1: float, radius: float = EARTH_RADIUS,
        periodic_x: bool = False,
    ) -> None:
        lam0, lam1 = np.radians(lon0), np.radians(lon1)
        phi0, phi1 = np.radians(lat0), np.radians(lat1)
        if not (-90.0 < lat0 < 90.0 and -90.0 < lat1 < 90.0):
            raise ValueError("latitudes must be strictly inside (-90, 90)")
        self.radius = float(radius)
        self.dlam = (lam1 - lam0) / nx
        self.dphi = (phi1 - phi0) / ny
        self.lam0 = lam0
        self.phi0 = phi0
        # Base init: logical arc-length spacings (x = R*lambda, y = R*phi).
        super().__init__(
            nx, ny, dx=radius * self.dlam, dy=radius * self.dphi,
            x0=radius * lam0, y0=radius * phi0,
            periodic_x=periodic_x, periodic_y=False,
        )
        self.uniform = False  # per-latitude metric
        phi_nodes = phi0 + np.arange(ny + 1) * self.dphi
        phi_centers = phi0 + (np.arange(ny) + 0.5) * self.dphi
        self._cos_node = np.cos(phi_nodes)  # (ny+1,)
        self._cos_center = np.cos(phi_centers)  # (ny,)
        self._zone_area = (
            radius * radius * self.dlam * np.diff(np.sin(phi_nodes))
        )  # (ny,) exact

    def __hash__(self) -> int:
        return hash((
            "spherical", self.nx, self.ny, self.radius,
            self.lam0, self.phi0, self.dlam, self.dphi, self.periodic_x,
        ))

    def __eq__(self, other) -> bool:
        return isinstance(other, SphericalMesh) and hash(self) == hash(other)

    # -- metric interface ------------------------------------------------------
    @property
    def dx(self):
        """Element-center zonal width R cos(phi_c) dlambda: (1, ny)."""
        return (self.radius * self.dlam) * self._cos_center[None, :]

    @property
    def dy(self):
        """Meridional spacing R dphi (latitude-independent)."""
        return float(self.radius * self.dphi)

    @property
    def cell_area(self):
        """Exact spherical zone areas: (1, ny)."""
        return self._zone_area[None, :]

    @property
    def face_len_x(self):
        """Meridional (left) faces all have length R dphi."""
        return float(self.radius * self.dphi)

    @property
    def face_len_y(self):
        """Zonal (bottom) face of row j: R cos(phi_j) dlambda, (1, ny)."""
        return (self.radius * self.dlam) * self._cos_node[None, :-1]

    def metric_factors(self):
        """Spherical metric as separable (col, row) factors — the x factor
        is trivial (the metric depends on latitude only); rows carry the
        SAME f64 expressions as the plane properties, so sliced local
        blocks are bit-identical to the static planes."""
        ones_x = np.ones(self.nx)
        ones_y = np.ones(self.ny)
        return {
            "dx": (ones_x, (self.radius * self.dlam) * self._cos_center),
            "dy": (ones_x, (self.radius * self.dphi) * ones_y),
            "area": (ones_x, self._zone_area),
            "face_x": (ones_x, (self.radius * self.dphi) * ones_y),
            "face_y": (ones_x, (self.radius * self.dlam) * self._cos_node[:-1]),
        }

    def lonlat_centers(self):
        """(lat, lon) element-center arrays in degrees, each (nx, ny)."""
        lons = np.degrees(self.lam0 + (np.arange(self.nx) + 0.5) * self.dlam)
        lats = np.degrees(self.phi0 + (np.arange(self.ny) + 0.5) * self.dphi)
        lat2d = np.broadcast_to(lats[None, :], (self.nx, self.ny))
        lon2d = np.broadcast_to(lons[:, None], (self.nx, self.ny))
        return lat2d, lon2d


class LocalMeshView(RectMesh):
    """The per-device (nx//px, ny//py) block of a NON-UNIFORM global mesh
    under ``shard_map``.

    shard_map traces ONE program for every device, so a static per-device
    metric is impossible — each device must fetch ITS slice of the global
    spacing at trace time. This view holds the GLOBAL mesh (static data)
    and exposes :meth:`local_metric`, which dynamic-slices the separable
    1-D metric factors (:meth:`RectMesh.metric_factors`) by the device's
    mesh coordinates (``lax.axis_index`` — the ``_local_ocean_mask``
    pattern) and outer-products them into this block's (nx, ny) planes.

    The static metric accessors (``dx``/``cell_area``/...) RAISE: any code
    reading them under shard_map would silently replicate one block's
    metric onto every device. Shape/topology accessors (nx, ny,
    periodic_*) describe the local block and work as usual.
    """

    is_local_view = True

    def __init__(self, global_mesh: RectMesh, px: int, py: int) -> None:
        if global_mesh.uniform:
            raise ValueError(
                "uniform global meshes shard as plain RectMesh local blocks"
            )
        if global_mesh.nx % px or global_mesh.ny % py:
            raise ValueError(
                f"grid {global_mesh.nx}x{global_mesh.ny} not divisible by "
                f"device mesh {px}x{py}"
            )
        super().__init__(
            nx=global_mesh.nx // px,
            ny=global_mesh.ny // py,
            # Placeholder spacing (never read: metric accessors raise).
            dx=float(np.mean(global_mesh.dx_array)),
            dy=float(np.mean(global_mesh.dy_array)),
            periodic_x=global_mesh.periodic_x,
            periodic_y=global_mesh.periodic_y,
        )
        self.uniform = False
        self.global_mesh = global_mesh
        self.px = int(px)
        self.py = int(py)

    def __hash__(self) -> int:
        return hash(("local_view", hash(self.global_mesh), self.px, self.py))

    def __eq__(self, other) -> bool:
        return isinstance(other, LocalMeshView) and hash(self) == hash(other)

    def _no_static_metric(self, name: str):
        raise TypeError(
            f"LocalMeshView.{name} is per-device and traced; use "
            "local_metric(spmd, dtype) (or the global_mesh) instead"
        )

    @property
    def dx(self):
        self._no_static_metric("dx")

    @property
    def dy(self):
        self._no_static_metric("dy")

    @property
    def cell_area(self):
        self._no_static_metric("cell_area")

    @property
    def face_len_x(self):
        self._no_static_metric("face_len_x")

    @property
    def face_len_y(self):
        self._no_static_metric("face_len_y")

    def element_centers(self):
        self._no_static_metric("element_centers")

    def node_coords(self):
        self._no_static_metric("node_coords")

    def edge_x_coords(self, s_edge):
        self._no_static_metric("edge_x_coords")

    def edge_y_coords(self, s_edge):
        self._no_static_metric("edge_y_coords")

    def volume_quad_coords(self, xq_vol, yq_vol):
        self._no_static_metric("volume_quad_coords")

    def local_metric(self, spmd, dtype):
        """This device's metric planes, each (nx, ny) traced arrays.

        ``spmd``: the ('X', 'Y')-style axis-name pair the caller runs
        under (None entries mean the axis is unsharded -> block 0).
        Returns dict(dx, dy, area, face_x, face_y). The factors are cast
        to ``dtype`` BEFORE the outer product, matching the static
        ``jnp.asarray(np.broadcast_to(...), dtype)`` planes bit-for-bit
        at f64.
        """
        import jax.numpy as jnp
        from jax import lax

        ax_x, ax_y = spmd
        if ax_x is None and self.px > 1:
            raise ValueError(
                "x axis is device-split (px > 1) but no shard_map axis "
                "name was given — the slice would silently be block 0's"
            )
        if ax_y is None and self.py > 1:
            raise ValueError(
                "y axis is device-split (py > 1) but no shard_map axis "
                "name was given — the slice would silently be block 0's"
            )
        ix = lax.axis_index(ax_x) * self.nx if ax_x is not None else 0
        iy = lax.axis_index(ax_y) * self.ny if ax_y is not None else 0
        out = {}
        for name, (col, row) in self.global_mesh.metric_factors().items():
            c = lax.dynamic_slice(
                jnp.asarray(col, dtype), (jnp.asarray(ix),), (self.nx,)
            )
            r = lax.dynamic_slice(
                jnp.asarray(row, dtype), (jnp.asarray(iy),), (self.ny,)
            )
            out[name] = c[:, None] * r[None, :]
        return out
