"""
Extrusion of planar meshes into conforming tetrahedral meshes (numpy,
carried over from ``vf_fem_tpu.mesh.extrude``).

The reference's 3D vocal-fold models are z-extrusions of the 2D M5
profiles, with one 1D fluid channel per z-plane (reference
``load.py:264-275``).  Each triangle prism is split into 3 tetrahedra by
the global-vertex-order rule, which picks the same diagonal on every
shared quad face, so the result is conforming.

Marker transfer:
- cells inherit the source triangle's marker (body/cover/ligament);
- lateral boundary facets inherit the source edge's marker
  (pressure/fixed): each marked 2D edge becomes 2 triangles per layer;
- the end caps (z = zs[0], zs[-1]) join the 'fixed' subdomain when
  ``fix_ends`` (the fold is clamped at its anterior and posterior
  attachments);
- marked vertices (separation points) are marked on every z-plane copy.
"""

from __future__ import annotations

import numpy as np

from .core import INT, Mesh

__all__ = ["extrude_mesh"]


def extrude_mesh(mesh2d: Mesh, zs, fix_ends: bool = True) -> Mesh:
    """Extrude a triangle mesh along z through the planes ``zs``."""
    zs = np.asarray(zs, dtype=float)
    if mesh2d.dim != 2 or zs.ndim != 1 or zs.size < 2:
        raise ValueError("extrude_mesh: a triangle mesh and at least two z-planes")
    nv2 = mesh2d.num_vertices
    nz = zs.size

    coords = np.concatenate(
        [np.concatenate([mesh2d.coords, np.full((nv2, 1), z)], axis=1) for z in zs],
        axis=0,
    )

    def vid(v, layer):
        return v + layer * nv2

    tris = np.asarray(mesh2d.cells)
    # each triangle's vertices sorted by global id: the diagonal rule that
    # makes neighbouring prisms' splits conform
    tris_sorted = np.sort(tris, axis=1)
    cells = []
    cell_markers = []
    mf2 = mesh2d.mesh_functions[2]
    for layer in range(nz - 1):
        a = tris_sorted + layer * nv2  # bottom (i < j < k)
        b = tris_sorted + (layer + 1) * nv2  # top
        i, j, k = a[:, 0], a[:, 1], a[:, 2]
        bi, bj, bk = b[:, 0], b[:, 1], b[:, 2]
        t1 = np.stack([i, j, k, bk], axis=1)
        t2 = np.stack([i, j, bj, bk], axis=1)
        t3 = np.stack([i, bi, bj, bk], axis=1)
        cells.append(np.concatenate([t1, t2, t3], axis=0))
        cell_markers.append(np.tile(mf2, 3))
    cells = np.concatenate(cells, axis=0)
    cell_markers = np.concatenate(cell_markers)

    m3 = Mesh(coords, cells.astype(INT))
    m3.mesh_functions[3][:] = cell_markers
    m3.subdomains[3] = dict(mesh2d.subdomains[2])

    # facet markers
    facets = np.asarray(m3.facets)
    key_to_facet = {
        tuple(sorted(facets[fi].tolist())): fi for fi in np.asarray(m3.boundary_facets)
    }
    mf1_2d = mesh2d.mesh_functions[1]
    edges2d = np.asarray(mesh2d.entities[1])
    mf2_3d = m3.mesh_functions[2]

    def mark_tri(v3, marker):
        f = key_to_facet.get(tuple(sorted(v3)))
        if f is not None:
            mf2_3d[f] = marker

    for ei in np.nonzero(mf1_2d)[0]:
        marker = int(mf1_2d[ei])
        va, vb = edges2d[ei]
        # the lateral quad (va, vb) x [layer, layer + 1] splits along the
        # diagonal from min(va, vb) bottom to max(va, vb) top, as the prisms
        lo, hi = (va, vb) if va < vb else (vb, va)
        for layer in range(nz - 1):
            l0, l1 = layer, layer + 1
            mark_tri([vid(lo, l0), vid(hi, l0), vid(hi, l1)], marker)
            mark_tri([vid(lo, l0), vid(lo, l1), vid(hi, l1)], marker)
    m3.subdomains[2] = dict(mesh2d.subdomains[1])

    if fix_ends:
        fixed_marker = m3.subdomains[2].get("fixed")
        if fixed_marker is None:
            fixed_marker = max(list(m3.subdomains[2].values()) + [0]) + 1
            m3.subdomains[2]["fixed"] = fixed_marker
        for layer in (0, nz - 1):
            base = layer * nv2
            for tri in tris:
                mark_tri([v + base for v in tri], fixed_marker)

    # vertex markers (separation points): every z-plane copy
    mf0_2d = mesh2d.mesh_functions[0]
    for v in np.nonzero(mf0_2d)[0]:
        for layer in range(nz):
            m3.mesh_functions[0][vid(v, layer)] = mf0_2d[v]
    m3.subdomains[0] = dict(mesh2d.subdomains[0])

    return m3
