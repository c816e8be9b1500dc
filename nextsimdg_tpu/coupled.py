"""The coupled sea-ice model: DG transport + mEVP dynamics + column physics.

The flagship configuration (BASELINE.json config 4: "coupled
thermo+dynamics ... with prescribed forcing"): per outer timestep

1. mEVP subcycled momentum solve on the current means (h, A);
2. DG advection of the prognostic tracers (hice, cice, hsnow) with the CG
   velocity;
3. bounds enforcement (0 <= A <= 1, h >= 0);
4. column thermodynamics on element means, with the higher DG moments
   rescaled to preserve the sub-element shape.

Everything is one jittable pure function over the CoupledState pytree;
sharding the (nx, ny) dims over a device mesh SPMD-partitions the whole
step (see nextsimdg_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from .dynamics.mesh import RectMesh
from .dynamics.mevp import DynamicsForcing, MEVPParams, VelocityState
from .dynamics.transport import DGTransport, velocity_from_cg
from .physics.nextsim_physics import NextsimPhysics
from .state import Forcing, PrognosticState, safe_div


def _pytree(cls):
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )


@_pytree
@dataclass(frozen=True)
class CoupledState:
    """Full prognostic state of the coupled model."""

    hice: jax.Array  #: DG coefficients of effective ice thickness (K, nx, ny)
    cice: jax.Array  #: DG coefficients of concentration (K, nx, ny)
    hsnow: jax.Array  #: DG coefficients of effective snow thickness (K, nx, ny)
    sst: jax.Array  #: (nx, ny)
    sss: jax.Array  #: (nx, ny)
    tice: jax.Array  #: (nlayers, nx, ny)
    velocity: VelocityState
    new_ice: jax.Array  #: carried physics state (nx, ny)

    @property
    def n_dg_dofs(self) -> int:
        return self.hice.shape[0]


class CoupledModel:
    def __init__(
        self,
        mesh: RectMesh,
        degree: int = 1,
        mevp_params: MEVPParams = MEVPParams(),
        n_subcycles: int = 100,
        physics: NextsimPhysics = None,
        spmd=(None, None),
        ocean_mask=None,
        mevp_backend: str = "auto",
        mevp_block_halo="auto",
        transport_substeps: int = 1,
        auto_substeps: bool = True,
        tvb_m: float = None,
    ) -> None:
        """``spmd``: device-mesh axis names when the model runs inside
        shard_map on LOCAL blocks (see parallel.shardmap); default is the
        single-program form, which GSPMD can also auto-shard.
        ``ocean_mask``: optional (nx, ny) element mask (1=ocean, 0=land) for
        pan-Arctic-style domains — coastline faces become impermeable and
        coastal nodes no-slip. ``mevp_backend``: momentum-solver backend
        ('auto', 'xla', or — under shard_map — 'blocked' for ghost-zone
        halo exchange). ``transport_substeps``:
        advect with k sub-steps of dt/k per coupled step — the explicit
        DG advection is stable for u dt/(k dx) below ~1/(2p+1).
        ``auto_substeps`` (default True): k is chosen PER STEP from the
        advective CFL of the post-mEVP velocity
        (``transport.cfl_substeps``; ``transport_substeps`` remains the
        floor), so strong-forcing configs stay stable with no hand-set
        substeps; False pins k = transport_substeps exactly.
        ``tvb_m``: TVB constant of the minmod slope limiter applied before
        positivity limiting at every RK stage (None = off, 0.0 = pure
        TVD; see DGTransport.limit_slopes)."""
        self.mesh = mesh
        self.spmd = tuple(spmd)
        self.ocean_mask = None if ocean_mask is None else jnp.asarray(ocean_mask)
        self.transport = DGTransport(
            mesh, degree=degree, spmd=self.spmd, tvb_m=tvb_m
        )
        # The momentum solver is module-selectable (Modules.Nextsim::IDynamics:
        # Nextsim::MEVPDynamics default, Nextsim::FreeDrift alternative).
        from .modules import ModuleRegistry

        solver_cls = ModuleRegistry.get_loader().get_implementation(
            "Nextsim::IDynamics"
        )
        solver_kwargs = {}
        if any(axis is not None for axis in self.spmd):
            # Ghost-zone width of the blocked halo exchange (must not
            # exceed the local block; only meaningful under shard_map).
            solver_kwargs["block_halo"] = mevp_block_halo
        self.mevp = solver_cls(
            mesh, mevp_params, backend=mevp_backend, spmd=self.spmd,
            **solver_kwargs,
        )
        self.n_subcycles = n_subcycles
        self.transport_substeps = max(1, int(transport_substeps))
        self.auto_substeps = bool(auto_substeps)
        if physics is None:
            physics = NextsimPhysics()  # default modules, default parameters
        self.physics = physics
        self._node_mask64 = None

    # -- state construction --------------------------------------------------
    @property
    def is_high_order(self) -> bool:
        from .dynamics.mevp_ho import MEVPSolverHO

        return isinstance(self.mevp, MEVPSolverHO)

    def initial_state(
        self, hice0=0.0, cice0=0.0, hsnow0=0.0, sst0=-1.8, sss0=32.0,
        tice0=-1.0, nlayers: int = 1, dtype=jnp.float32,
    ) -> CoupledState:
        nx, ny = self.mesh.nx, self.mesh.ny
        k = self.transport.basis.n_dofs
        dg = lambda v: jnp.zeros((k, nx, ny), dtype).at[0].set(v)
        if self.is_high_order:
            from .dynamics.mevp_ho import HOVelocityState

            velocity = HOVelocityState.zeros(nx, ny, dtype)
        else:
            velocity = VelocityState.zeros(nx, ny, dtype)
        return CoupledState(
            hice=dg(hice0),
            cice=dg(cice0),
            hsnow=dg(hsnow0),
            sst=jnp.full((nx, ny), sst0, dtype),
            sss=jnp.full((nx, ny), sss0, dtype),
            tice=jnp.full((nlayers, nx, ny), tice0, dtype),
            velocity=velocity,
            new_ice=jnp.zeros((nx, ny), dtype),
        )

    def _local_ocean_mask(self, dtype):
        """This device's block of the (global) ocean mask.

        Outside shard_map the mask IS the local block. Inside, the model
        holds the GLOBAL mask (a trace-time constant) and every device
        slices its own (nx, ny) block by mesh coordinates — masks stay a
        plain constructor argument under the explicit SPMD driver.
        """
        if self.ocean_mask is None:
            return None
        ocean = self.ocean_mask.astype(dtype)
        ax_x, ax_y = self.spmd
        if ax_x is None and ax_y is None:
            return ocean
        from jax import lax

        bx, by = self.mesh.nx, self.mesh.ny  # the LOCAL block shape
        ix = lax.axis_index(ax_x) if ax_x is not None else 0
        iy = lax.axis_index(ax_y) if ax_y is not None else 0
        return lax.dynamic_slice(ocean, (ix * bx, iy * by), (bx, by))

    def node_mask(self, dtype):
        mask = self.mevp.boundary_mask(dtype=dtype)
        if self.ocean_mask is None:
            return mask
        from .dynamics.stencil import shift_m

        px, py = self.mesh.periodic_x, self.mesh.periodic_y
        ocean = self._local_ocean_mask(dtype)
        if self.is_high_order:
            from .dynamics.mevp_ho import HOField

            o_x = shift_m(ocean, 0, px, self.spmd[0])
            o_y = shift_m(ocean, 1, py, self.spmd[1])
            o_xy = shift_m(o_x, 1, py, self.spmd[1])
            return HOField(
                v=mask.v * ocean * o_x * o_y * o_xy,  # vertex: all 4 elements
                b=mask.b * ocean * o_y,  # bottom mid: (i,j) and (i,j-1)
                l=mask.l * ocean * o_x,  # left mid: (i,j) and (i-1,j)
                c=mask.c * ocean,  # center: its element
            )
        # CG1 node (i,j): no-slip unless all 4 adjacent elements are ocean.
        o_x = shift_m(ocean, 0, px, self.spmd[0])
        o_y = shift_m(ocean, 1, py, self.spmd[1])
        o_xy = shift_m(o_x, 1, py, self.spmd[1])
        return mask * ocean * o_x * o_y * o_xy

    def face_masks(self, dtype):
        if self.ocean_mask is None:
            return None
        from .dynamics.transport import face_masks_from_land

        return face_masks_from_land(
            self._local_ocean_mask(dtype),
            self.mesh.periodic_x, self.mesh.periodic_y, self.spmd,
        )

    # -- one coupled timestep ------------------------------------------------
    @partial(jax.jit, static_argnames=("self", "dt", "do_dynamics", "do_thermo"))
    def step(
        self,
        state: CoupledState,
        phys_forcing: Forcing,
        dyn_forcing: DynamicsForcing,
        dt: float,
        do_dynamics: bool = True,
        do_thermo: bool = True,
    ) -> CoupledState:
        dtype = state.hice.dtype
        velocity = state.velocity
        hice, cice, hsnow = state.hice, state.cice, state.hsnow

        if do_dynamics:
            # 1. momentum: mEVP on cell means.
            h_mean = hice[0]
            a_mean = jnp.clip(cice[0], 0.0, 1.0)
            if self.is_high_order:
                from .dynamics.mevp_ho import (
                    HODynamicsForcing,
                    HOField,
                    ho_velocity_to_quad,
                )

                px, py = self.mesh.periodic_x, self.mesh.periodic_y
                to_ho = lambda f: HOField.from_vertex_field(f, px, py, self.spmd)
                forcing_ho = HODynamicsForcing(
                    u_atm=to_ho(dyn_forcing.u_atm), v_atm=to_ho(dyn_forcing.v_atm),
                    u_ocean=to_ho(dyn_forcing.u_ocean),
                    v_ocean=to_ho(dyn_forcing.v_ocean),
                )
                mask = self.node_mask(dtype)
                velocity = self.mevp.step(
                    velocity, h_mean, a_mean, forcing_ho, mask, dt, self.n_subcycles
                )
                qv = ho_velocity_to_quad(
                    self.mesh, self.transport.basis, velocity.u, velocity.v, self.spmd
                )
            else:
                mask = self.node_mask(dtype)
                velocity = self.mevp.step(
                    velocity, h_mean, a_mean, dyn_forcing, mask, dt, self.n_subcycles
                )
                qv = velocity_from_cg(
                    self.mesh, self.transport.basis, velocity.u, velocity.v, self.spmd
                )

            # 2. DG advection of the tracers with the sampled velocity, with
            # pointwise positivity limiting (Zhang-Shu) per RK stage. The
            # three tracers ride one batched pass (shared velocity reads).
            tracers = jnp.stack([hice, cice, hsnow], axis=1)  # (K, 3, nx, ny)
            masks = self.face_masks(dtype)
            if self.auto_substeps:
                # CFL-adaptive substep count (traced; fori_loop lowers to a
                # dynamic-trip-count while_loop). transport_substeps = floor.
                from .dynamics.transport import cfl_substeps

                k = cfl_substeps(
                    qv, dt, self.mesh, self.transport.basis.degree,
                    k_floor=self.transport_substeps, spmd=self.spmd,
                )
                dt_sub = dt / k.astype(dtype)
                tracers = jax.lax.fori_loop(
                    0, k,
                    lambda _, tr: self.transport.step(
                        tr, qv, dt_sub, limit=True, face_masks=masks
                    ),
                    tracers,
                )
            else:
                for _ in range(self.transport_substeps):
                    tracers = self.transport.step(
                        tracers, qv, dt / self.transport_substeps,
                        limit=True, face_masks=masks,
                    )
            hice, cice, hsnow = tracers[:, 0], tracers[:, 1], tracers[:, 2]

            # 3. bounds: means clamped, higher moments scaled accordingly.
            hice = _clamp_dg(hice, 0.0, None)
            cice = _clamp_dg(cice, 0.0, 1.0)
            hsnow = _clamp_dg(hsnow, 0.0, None)

        new_ice = state.new_ice
        sst, sss, tice = state.sst, state.sss, state.tice
        if do_thermo:
            # 4. column physics on element means.
            prog = PrognosticState(
                hice=hice[0], cice=cice[0], hsnow=hsnow[0], sst=sst, sss=sss, tice=tice,
            )
            updated, diags = self.physics.step(prog, phys_forcing, new_ice, dt)
            new_ice = diags.new_ice
            if self.ocean_mask is not None:
                # No ocean under land elements: the column physics (incl.
                # new-ice formation in open "water") must not act there.
                m = self._local_ocean_mask(dtype)
                keep = lambda new, old: jnp.where(m == 1.0, new, old)
                updated = dataclasses.replace(
                    updated,
                    hice=keep(updated.hice, prog.hice),
                    cice=keep(updated.cice, prog.cice),
                    hsnow=keep(updated.hsnow, prog.hsnow),
                    sst=keep(updated.sst, prog.sst),
                    sss=keep(updated.sss, prog.sss),
                    tice=jnp.where(m[None] == 1.0, updated.tice, prog.tice),
                )
                new_ice = keep(new_ice, state.new_ice)
            hice = _rescale_dg(hice, updated.hice)
            cice = _rescale_dg(cice, updated.cice)
            hsnow = _rescale_dg(hsnow, updated.hsnow)
            tice = updated.tice
            sst, sss = updated.sst, updated.sss

        return CoupledState(
            hice=hice, cice=cice, hsnow=hsnow, sst=sst, sss=sss, tice=tice,
            velocity=velocity, new_ice=new_ice,
        )

    @partial(jax.jit, static_argnames=("self", "dt", "n_steps", "do_dynamics", "do_thermo"))
    def run(
        self,
        state: CoupledState,
        phys_forcing: Forcing,
        dyn_forcing: DynamicsForcing,
        dt: float,
        n_steps: int,
        do_dynamics: bool = True,
        do_thermo: bool = True,
    ) -> CoupledState:
        """n_steps coupled steps on device (lax.scan over the outer loop)."""

        def body(s, _):
            return (
                self.step(s, phys_forcing, dyn_forcing, dt, do_dynamics, do_thermo),
                None,
            )

        out, _ = jax.lax.scan(body, state, None, length=n_steps)
        return out


def _clamp_dg(coeffs, lo, hi):
    """Clamp the cell mean; zero higher moments where the mean was clamped."""
    mean = coeffs[0]
    clamped = jnp.clip(mean, lo, hi)
    at_bound = clamped != mean
    rest = jnp.where(at_bound[None], 0.0, coeffs[1:])
    return jnp.concatenate([clamped[None], rest], axis=0)


def _rescale_dg(coeffs, new_mean):
    """Replace the mean, scaling higher moments by new/old (shape-preserving)."""
    old_mean = coeffs[0]
    ratio = safe_div(new_mean, old_mean)
    return jnp.concatenate([new_mean[None], coeffs[1:] * ratio[None]], axis=0)
