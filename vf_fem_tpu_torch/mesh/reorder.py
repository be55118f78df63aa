"""
Mesh vertex renumbering for bandwidth reduction (host-side numpy/scipy,
carried over from ``vf_fem_tpu.mesh.reorder``).

The block-banded Jacobian (``solvers.bsb``) and the banded assembly
(``fem.banded``) need the mesh numbered so that adjacent vertices have
nearby indices; reverse Cuthill–McKee on the vertex adjacency graph gives
a bandwidth of O(sqrt(n_vertices)) on planar meshes.  Renumbering at load
time keeps the dof ordering ``dof = vertex*dim + comp`` with no permutation
on the device.
"""

from __future__ import annotations

import numpy as np

from .core import INT, Mesh

__all__ = ["rcm_permutation", "rcm_mesh", "permute_mesh"]


def rcm_permutation(mesh: Mesh) -> np.ndarray:
    """RCM vertex permutation: ``perm[new_id] = old_id``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    cells = np.asarray(mesh.cells)
    nv = mesh.num_vertices
    k = cells.shape[1]
    pairs = [(a, b) for a in range(k) for b in range(k) if a != b]
    ii = np.concatenate([cells[:, a] for a, _ in pairs])
    jj = np.concatenate([cells[:, b] for _, b in pairs])
    G = coo_matrix((np.ones_like(ii), (ii, jj)), shape=(nv, nv)).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(G, symmetric_mode=True), dtype=np.int64
    )


def rcm_mesh(mesh: Mesh) -> Mesh:
    """A new :class:`Mesh` with RCM-renumbered vertices (markers and
    subdomain names transfer) and sorted cells (see :func:`permute_mesh`)."""
    return permute_mesh(mesh, rcm_permutation(mesh))


def permute_mesh(mesh: Mesh, perm: np.ndarray) -> Mesh:
    """Renumber vertices by ``perm`` (new id i <- old id perm[i]) and sort
    the cells by their minimum new vertex id, so that consecutive cells
    touch a contiguous vertex window (the banded assembly's precondition):
    vertex markers permute, cell markers follow their cells, facet markers
    are re-matched by vertex tuple."""
    perm = np.asarray(perm)
    inv = np.argsort(perm)

    coords2 = np.asarray(mesh.coords)[perm]
    cells2 = inv[np.asarray(mesh.cells)].astype(INT)
    cell_perm = np.argsort(cells2.min(axis=1), kind="stable")
    m2 = Mesh(coords2, cells2[cell_perm])

    dim = mesh.dim
    m2.mesh_functions[0][:] = mesh.mesh_functions[0][perm]
    m2.subdomains[0] = dict(mesh.subdomains[0])
    m2.mesh_functions[dim][:] = mesh.mesh_functions[dim][cell_perm]
    m2.subdomains[dim] = dict(mesh.subdomains[dim])
    for d in mesh.entities:
        if d in (0, dim):
            continue
        m2.subdomains[d] = dict(mesh.subdomains[d])
        marked = np.nonzero(mesh.mesh_functions[d])[0]
        if marked.size == 0:
            continue
        lookup = {
            tuple(sorted(row.tolist())): i
            for i, row in enumerate(np.asarray(m2.entities[d]))
        }
        old_ents = np.asarray(mesh.entities[d])
        mf2 = m2.mesh_functions[d]
        for e in marked:
            mf2[lookup[tuple(sorted(inv[old_ents[e]].tolist()))]] = (
                mesh.mesh_functions[d][e]
            )
    return m2
