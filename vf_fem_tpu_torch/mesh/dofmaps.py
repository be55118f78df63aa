"""
Label -> DOF maps (reference: ``src/femvf/meshutils.py:345-438``; a copy
of ``vf_fem_tpu.mesh.dofmaps`` on the port's :class:`Mesh`).

With vertex-major dof ordering these are pure index computations:
scalar-CG1 dof == vertex id; vector-CG1 dofs are ``vertex*dim + comp``;
DG0 dof == cell id.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh


def vertices_from_subdomain(mesh: Mesh, dim: int, name: str) -> np.ndarray:
    """Unique vertex ids of entities in a named subdomain."""
    marker = mesh.subdomains[dim][name]
    ents = mesh.entities[dim][mesh.mesh_functions[dim] == marker]
    return np.unique(ents.reshape(-1))


def dofs_from_mesh_func(
    mesh: Mesh, dim: int, value: int, vector: bool = False
) -> np.ndarray:
    """DOFs of CG1 functions on entities with a given marker value
    (reference: ``meshutils.py:345-380``)."""
    ents = mesh.entities[dim][mesh.mesh_functions[dim] == value]
    verts = np.unique(ents.reshape(-1))
    if not vector:
        return verts
    gdim = mesh.dim
    return (verts[:, None] * gdim + np.arange(gdim)[None, :]).reshape(-1)


def process_meshlabel_to_dofs(
    mesh: Mesh, element_type="facet", vector: bool = False
) -> dict:
    """{subdomain name: CG1 dofs} (reference: ``meshutils.py:383-410``)."""
    d = mesh.element_type_dim(element_type)
    return {
        name: dofs_from_mesh_func(mesh, d, marker, vector=vector)
        for name, marker in mesh.subdomains[d].items()
    }


def process_celllabel_to_dofs_from_residual(residual) -> dict:
    """{cell subdomain name: DG0 dofs (cell ids)}
    (reference: ``meshutils.py:413-438``)."""
    mesh = residual.mesh()
    d = mesh.dim
    return {
        name: np.nonzero(mesh.mesh_functions[d] == marker)[0]
        for name, marker in mesh.subdomains[d].items()
    }
