"""Sea-ice dynamical core: DG transport + mEVP rheology.

The reference snapshot reserves a ``dynamics`` component but contains no code
(``CMakeLists.txt:43-46``); this package supplies the north-star capability
(BASELINE.json): higher-order discontinuous-Galerkin advection of the ice
tracers and the mEVP-subcycled viscous-plastic momentum solver, designed
for accelerators:

* tracers are stored as DG coefficient arrays ``(ndof, nx, ny)`` — a
  structure-of-arrays layout whose big spatial dims are contiguous;
* the DG basis is orthogonal on the reference square, so the per-element
  mass matrix is *diagonal* — the "dense mass-matrix solve" of unstructured
  meshes reduces to a constant rescale, and the whole RHS is elementwise
  math + neighbor shifts that XLA fuses into a few elementwise passes;
* the mEVP subcycle loop is a ``lax.fori_loop`` of stencil updates,
  sharded over a 2-D device mesh with halo exchange (see
  ``nextsimdg_tpu.parallel``).
"""

from .mesh import RectMesh
from .dgbasis import DGBasis, dg_basis
from .transport import DGTransport
from .mevp import MEVPSolver, MEVPParams, VelocityState
from .freedrift import FreeDriftSolver

from ..modules import ModuleRegistry as _ModuleRegistry

# The dynamics (momentum) solver is a runtime-selectable module, extending
# the reference's module-system pattern to the dynamical core. The
# registered "instance" is the solver CLASS; the CoupledModel instantiates
# it with (mesh, params, spmd=...). mEVP is the default (first registered).
from .mevp_ho import MEVPSolverHO

_loader = _ModuleRegistry.get_loader()
_loader.register("Nextsim::IDynamics", "Nextsim::MEVPDynamics", lambda: MEVPSolver)
_loader.register("Nextsim::IDynamics", "Nextsim::FreeDrift", lambda: FreeDriftSolver)
_loader.register("Nextsim::IDynamics", "Nextsim::MEVPHighOrder", lambda: MEVPSolverHO)

__all__ = [
    "RectMesh",
    "DGBasis",
    "dg_basis",
    "DGTransport",
    "MEVPSolver",
    "MEVPParams",
    "VelocityState",
    "FreeDriftSolver",
]
