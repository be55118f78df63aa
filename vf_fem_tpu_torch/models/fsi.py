"""
Fluid-solid interface map (counterpart of ``vf_fem_tpu.models.fsi``): the
1-to-1 correspondence between the fluid's interface points and the solid's
interface vertices, and the coupling Jacobians it gives, as numpy arrays.
"""

from __future__ import annotations

import numpy as np


class FSIMap:
    """Fluid dofs ``fluid_dofs[j]`` and solid vertices ``solid_dofs[j]``
    are the same interface point."""

    def __init__(self, ndof_fluid: int, ndof_solid: int, fluid_dofs, solid_dofs):
        self.N_FLUID = int(ndof_fluid)
        self.N_SOLID = int(ndof_solid)
        self.dofs_fluid = np.asarray(fluid_dofs, dtype=np.int64)
        self.dofs_solid = np.asarray(solid_dofs, dtype=np.int64)

    def dsolid_dfluid(self) -> np.ndarray:
        """(N_SOLID, N_FLUID): a solid field from a fluid one."""
        A = np.zeros((self.N_SOLID, self.N_FLUID))
        A[self.dofs_solid, self.dofs_fluid] = 1.0
        return A

    def dfluid_dsolid_u(self, dim: int) -> np.ndarray:
        """(N_FLUID, N_SOLID * dim): the fluid area ``2 (ymid - y)`` by the
        solid displacement, ``-2`` at each interface vertex's y dof (the JAX
        package's ``dfluid_dsolid() @ make_dslarea_dslu(...)``, without the
        dense (nvert, ndof) factor)."""
        A = np.zeros((self.N_FLUID, self.N_SOLID * dim))
        A[self.dofs_fluid, self.dofs_solid * dim + 1] = -2.0
        return A
