"""
Derivation of 1D fluid interface meshes from solid facet subdomains.

Replicates ``derive_1D_interface_from_facet_subdomain`` and friends
(reference: ``src/femvf/load.py:164-293``) in pure numpy: filter boundary
facets by subdomain (and by z-plane for extruded 3D meshes), extract the
edge chain, sort its vertices by nearest-neighbour walk from the origin,
and return arc-length coordinates plus matched solid/fluid DOF arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .core import INT, Mesh, sort_vertices_by_nearest_neighbours, vertices_from_edges


def _boundary_edges_by_subdomain(mesh: Mesh, facet_values: set) -> np.ndarray:
    """
    Return edge entities (as vertex pairs) on marked boundary facets.

    In 2D edges are the facets themselves.  In 3D, edges incident to a marked
    facet are returned (reference filters ``dfn.edges(mesh)`` by incidence,
    ``src/femvf/meshutils.py:171-213``).
    """
    dim = mesh.dim
    facets = mesh.facets
    mf = mesh.mesh_functions[dim - 1]
    bmask = np.zeros(facets.shape[0], dtype=bool)
    bmask[mesh.boundary_facets] = True
    marked = bmask & np.isin(mf, list(facet_values))
    marked_facets = facets[marked]

    if dim == 2:
        return marked_facets  # (n, 2) vertex pairs

    # 3D: decompose marked triangle facets into their edges
    e01 = marked_facets[:, [0, 1]]
    e02 = marked_facets[:, [0, 2]]
    e12 = marked_facets[:, [1, 2]]
    edges = np.concatenate([e01, e02, e12], axis=0)
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    return edges


def _edges_on_plane(
    mesh: Mesh, edges: np.ndarray, origin: np.ndarray, normal: np.ndarray
) -> np.ndarray:
    """Filter edges whose midpoints lie on a plane (3D extruded meshes)."""
    mids = mesh.coords[edges].mean(axis=1)
    gdim = mids.shape[1]
    d = (mids - origin[:gdim]) @ normal[:gdim]
    return edges[np.isclose(d, 0.0)]


def derive_edge_mesh_from_edges(mesh: Mesh, edges: np.ndarray):
    """
    Arc-length coordinates + sorted vertex ids for a connected edge chain
    (reference: ``src/femvf/load.py:283-293``).
    """
    vertices = vertices_from_edges(edges)
    coords = mesh.coords[vertices]
    idx_sort = sort_vertices_by_nearest_neighbours(coords)
    sorted_coords = coords[idx_sort]
    dxyz = sorted_coords[1:] - sorted_coords[:-1]
    dx, dy = dxyz[:, 0], dxyz[:, 1]
    s = np.concatenate([[0.0], np.cumsum(np.sqrt(dx**2 + dy**2))])
    return s, vertices[idx_sort]


def derive_1d_interface(
    mesh: Mesh,
    facet_subdomains: Sequence[str] = ("pressure",),
    zs: Optional[np.ndarray] = None,
):
    """
    Return ``(s, solid_dofs, fluid_dofs)`` for FSI coupling
    (reference: ``src/femvf/load.py:164-214``).

    ``s``: arc-length coordinates, shape ``(n,)`` in 2D or ``(n_z, n)`` for
    extruded 3D meshes (one 1D channel per z-plane).
    ``solid_dofs``: scalar-CG1 (vertex) DOFs on the solid interface, matched
    1-to-1 to fluid pressure DOFs ``fluid_dofs``.
    """
    dim = mesh.dim
    sub = mesh.subdomains[dim - 1]
    facet_values = {sub[name] for name in facet_subdomains}
    edges = _boundary_edges_by_subdomain(mesh, facet_values)

    if dim == 2:
        s, verts = derive_edge_mesh_from_edges(mesh, edges)
        solid_dofs = verts.astype(INT)  # scalar CG1 dof == vertex id
        fluid_dofs = np.arange(verts.size, dtype=INT)
        return s, solid_dofs, fluid_dofs

    if zs is None:
        raise ValueError("`zs` must be an array of z-planes for a 3D mesh")

    s_list, vert_list = [], []
    for z in np.asarray(zs):
        plane_edges = _edges_on_plane(
            mesh, edges, np.array([0.0, 0.0, z]), np.array([0.0, 0.0, 1.0])
        )
        s, verts = derive_edge_mesh_from_edges(mesh, plane_edges)
        s_list.append(s)
        vert_list.append(verts)
    s = np.array(s_list)
    verts = np.array(vert_list, dtype=INT)
    solid_dofs = verts.reshape(-1).astype(INT)
    fluid_dofs = np.arange(solid_dofs.size, dtype=INT)
    return s, solid_dofs, fluid_dofs


def locate_separation_vertex(mesh: Mesh, label: str = "separation") -> int:
    """The vertex marked ``label`` in the mesh's vertex functions; raises
    ``ValueError`` unless exactly one vertex carries it."""
    sub = mesh.subdomains.get(0, {})
    if label not in sub:
        raise ValueError(f"Couldn't find separation point label {label}")
    verts = np.nonzero(mesh.mesh_functions[0] == sub[label])[0]
    if len(verts) != 1:
        raise ValueError(
            f"A single separation point was expected but {len(verts)} were found"
        )
    return int(verts[0])
