"""
Programmatic mesh generators for the test fixtures (plain numpy, from
``vf_fem_tpu.mesh.primitives``): the analytic M5-like vocal-fold
cross-section, and the unit square with the reference's fixture markers.
"""

from __future__ import annotations

import numpy as np

from .core import INT, Mesh

EPS = 1e-12



def unit_square_mesh(nx: int, ny: int) -> Mesh:
    """Structured triangulation of the unit square (right-diagonal split)."""
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    coords = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)

    def vid(i, j):
        return j * (nx + 1) + i

    cells = []
    for j in range(ny):
        for i in range(nx):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            cells.append([v00, v10, v11])
            cells.append([v00, v11, v01])
    return Mesh(coords, np.array(cells, dtype=INT))


def mark_unit_mesh_fixtures(mesh: Mesh) -> Mesh:
    """The reference's test-fixture markers on a unit square mesh: facets
    'fixed' = 1 on the bottom and 'pressure' = 0 elsewhere on the boundary,
    the vertex 'separation' = 1 at the top-right corner, cells 'top' = 1
    for y > 0.5 and 'bottom' = 0."""
    dim = mesh.dim

    def is_fixed(mids, vcoords):
        return np.all(vcoords[..., 1] < EPS, axis=-1)

    mesh.mark_entities(dim - 1, is_fixed, 1, name="fixed", boundary_only=True)
    mesh.subdomains[dim - 1]["pressure"] = 0

    def is_sep(mids, vcoords):
        return np.all(
            (vcoords[..., 0] > 1 - EPS) & (vcoords[..., 1] > 1 - EPS), axis=-1
        )

    mesh.mark_entities(dim - 2, is_sep, 1, name="separation")

    def is_top(mids, vcoords):
        return mids[:, 1] > 0.5 + EPS

    mesh.mark_entities(dim, is_top, 1, name="top")
    mesh.subdomains[dim]["bottom"] = 0
    return mesh

def _m5_surface_profile(x: np.ndarray, depth: float, tmed: float) -> np.ndarray:
    """
    A smooth M5-like vocal-fold medial-surface profile ``y_s(x)``.

    The M5 (Scherer) cross-section has a gently convergent inferior surface,
    a near-vertical medial surface, and a rounded superior edge.  The exact
    CAD geometry in the reference lives in STEP files
    (reference: ``meshes/stp/M5_CB_GA3.STEP``) that cannot be triangulated
    without gmsh; this analytic stand-in reproduces the qualitative profile
    (entrance ramp, medial bulge near the superior end) for benchmarks/tests.
    """
    t = np.clip(x / x.max() if x.max() > 0 else x, 0.0, 1.0)
    # ramp up to the medial surface with a rounded superior edge
    ramp = np.sin(0.5 * np.pi * np.minimum(t / 0.8, 1.0)) ** 2
    bulge = np.exp(-(((t - 0.85) / 0.12) ** 2)) * 0.08
    return depth * ramp + tmed * bulge


def vocal_fold_mesh(
    nx: int = 24,
    ny: int = 12,
    length: float = 1.2,
    depth: float = 0.55,
    tmed: float = 0.3,
) -> Mesh:
    """
    2D vocal-fold cross-section mesh (M5-like), CGS units (cm).

    The fold occupies ``x in [0, length]`` with its fixed (lateral) boundary
    at ``y = 0`` and the flow-facing surface at ``y = y_s(x)``.  Facet
    subdomains: 'fixed' (bottom + lateral sides), 'pressure' (the
    superior/medial surface, i.e. the FSI interface).  Cell subdomains:
    'body' (lower half) and 'cover' (upper half), mirroring the M5
    body-cover physical groups (reference: ``meshes/genmesh_M5_CB.py:10-66``).
    """
    xs = np.linspace(0.0, length, nx + 1)
    ysurf = _m5_surface_profile(xs, depth, tmed)
    eta = np.linspace(0.0, 1.0, ny + 1)

    coords = np.zeros(((nx + 1) * (ny + 1), 2))
    for j, e in enumerate(eta):
        coords[j * (nx + 1) : (j + 1) * (nx + 1), 0] = xs
        coords[j * (nx + 1) : (j + 1) * (nx + 1), 1] = e * ysurf

    # Collapse duplicate points where ysurf == 0 (the inferior end) by
    # shifting them slightly to keep elements valid: give the surface a small
    # minimum height so the mapped grid is non-degenerate.
    min_h = 0.08 * depth
    ysurf_eff = np.maximum(ysurf, min_h * np.linspace(1.0, 1.0, nx + 1))
    for j, e in enumerate(eta):
        coords[j * (nx + 1) : (j + 1) * (nx + 1), 1] = e * ysurf_eff

    def vid(i, j):
        return j * (nx + 1) + i

    cells = []
    for j in range(ny):
        for i in range(nx):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            cells.append([v00, v10, v11])
            cells.append([v00, v11, v01])
    mesh = Mesh(coords, np.array(cells, dtype=INT))

    def is_fixed(mids, vcoords):
        bottom = np.all(vcoords[..., 1] < EPS, axis=-1)
        left = np.all(vcoords[..., 0] < EPS, axis=-1)
        return bottom | left

    def is_pressure(mids, vcoords):
        return ~is_fixed(mids, vcoords)

    mesh.mark_entities(1, is_pressure, 2, name="pressure", boundary_only=True)
    mesh.mark_entities(1, is_fixed, 1, name="fixed", boundary_only=True)

    # body/cover split at eta = 0.5 of the local thickness
    def is_cover(mids, vcoords):
        i = np.clip(
            np.searchsorted(xs, mids[:, 0]) - 1, 0, nx
        )
        local_h = ysurf_eff[i]
        return mids[:, 1] > 0.5 * local_h

    mesh.mark_entities(2, is_cover, 1, name="cover")
    mesh.subdomains[2]["body"] = 0

    # Mark a 'separation' vertex near the superior edge (max y)
    ysurf_max = coords[:, 1].max()

    def is_sep(mids, vcoords):
        return np.all(vcoords[..., 1] > ysurf_max - EPS, axis=-1) & np.all(
            vcoords[..., 0] >= coords[coords[:, 1] > ysurf_max - EPS, 0].max() - EPS,
            axis=-1,
        )

    mesh.mark_entities(0, is_sep, 1, name="separation")
    return mesh
