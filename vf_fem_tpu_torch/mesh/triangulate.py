"""
Planar multi-region triangulation (host-side, numpy + scipy.spatial).

Replaces gmsh's 2D mesher for the M5 vocal-fold profiles (reference
``meshes/genmesh_M5_CB.py:33`` calls ``gmsh.model.mesh.generate(2)``; gmsh
is not a dependency here).  The algorithm is distmesh-flavored:

1. each B-rep edge is discretized once at target spacing ``h`` (shared
   edges therefore match exactly across regions -> conforming interfaces);
2. each region gets interior points on a hexagonal lattice, clipped away
   from the boundary;
3. a few rounds of Delaunay + spring relaxation (repulsive-only forces,
   Persson & Strang's distmesh scheme) even out interior spacing;
4. per-region triangulations are merged on the shared boundary points and
   tagged: cells by region name, boundary facets / vertices by the groups
   the caller derived from the B-rep.
"""

from __future__ import annotations

import numpy as np

from .core import INT, Mesh
from .step_io import StepEdge

__all__ = ["edge_points", "triangulate_regions"]


def edge_points(edge: StepEdge, h: float) -> np.ndarray:
    """Discretize an edge at spacing <= h, endpoints included, (m, 2)."""
    if edge.kind == "line":
        length = float(np.linalg.norm(edge.p1 - edge.p0))
        m = max(1, int(np.ceil(length / h)))
        t = np.linspace(0.0, 1.0, m + 1)[:, None]
        return edge.p0[None, :] * (1 - t) + edge.p1[None, :] * t
    # arc: sample at chord length <= h
    from .step_io import discretize_edge

    return discretize_edge(edge, max_seg=h)


def _polygon_signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Winding-number point-in-polygon (vectorized over pts).

    This is the mesh-generation hot spot (O(n_pts * n_poly) per smoothing
    iteration): the numpy path of the JAX package's mesher, which may take
    a native C++ kernel here instead."""
    x0 = poly  # (m, 2)
    x1 = np.roll(poly, -1, axis=0)
    # for each point, sum crossing contributions
    px = pts[:, None, 0]
    py = pts[:, None, 1]
    cond_up = (x0[None, :, 1] <= py) & (x1[None, :, 1] > py)
    cond_dn = (x0[None, :, 1] > py) & (x1[None, :, 1] <= py)
    # cross product sign: is the point left of the edge?
    cross = (x1[None, :, 0] - x0[None, :, 0]) * (py - x0[None, :, 1]) - (
        px - x0[None, :, 0]
    ) * (x1[None, :, 1] - x0[None, :, 1])
    wn = np.sum(cond_up & (cross > 0), axis=1) - np.sum(
        cond_dn & (cross < 0), axis=1
    )
    return wn != 0


def _dist_to_polyline(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Min distance from each point to the closed polygon boundary."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a  # (m, 2)
    ab2 = np.maximum(np.sum(ab**2, axis=1), 1e-30)
    ap = pts[:, None, :] - a[None, :, :]  # (n, m, 2)
    t = np.clip(np.einsum("nmk,mk->nm", ap, ab) / ab2[None, :], 0.0, 1.0)
    closest = a[None, :, :] + t[..., None] * ab[None, :, :]
    d = np.linalg.norm(pts[:, None, :] - closest, axis=-1)
    return d.min(axis=1)


def _hex_lattice(bbox, h: float) -> np.ndarray:
    (xmin, ymin), (xmax, ymax) = bbox
    dy = h * np.sqrt(3.0) / 2.0
    ys = np.arange(ymin + 0.5 * dy, ymax, dy)
    rows = []
    for i, y in enumerate(ys):
        xoff = 0.25 * h if i % 2 else -0.25 * h
        xs = np.arange(xmin + 0.5 * h + xoff, xmax, h)
        rows.append(np.stack([xs, np.full_like(xs, y)], axis=1))
    if not rows:
        return np.zeros((0, 2))
    return np.concatenate(rows, axis=0)


def _triangulate_polygon(
    boundary: np.ndarray, h: float, smooth_iters: int = 25
):
    """Mesh one polygon: returns (points, triangles) with
    ``points[:len(boundary)] == boundary`` (fixed)."""
    from scipy.spatial import Delaunay

    nb = boundary.shape[0]
    bbox = (boundary.min(axis=0), boundary.max(axis=0))
    seeds = _hex_lattice(bbox, h)
    if seeds.shape[0]:
        inside = _points_in_polygon(seeds, boundary)
        far = _dist_to_polyline(seeds, boundary) > 0.55 * h
        seeds = seeds[inside & far]
    pts = np.concatenate([boundary, seeds], axis=0)

    def good_tris(p):
        tri = Delaunay(p)
        cells = tri.simplices
        cent = p[cells].mean(axis=1)
        keep = _points_in_polygon(cent, boundary)
        cells = cells[keep]
        # Delaunay of collinear boundary points (straight profile edges)
        # emits exactly-degenerate simplices; drop them (no hole results)
        v = p[cells]
        area2 = np.abs(
            (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1])
        )
        return cells[area2 > 1e-9 * h * h]

    # distmesh-style relaxation of the interior points
    h0 = 1.2 * h  # desired bar length slightly above h (repulsive-only)
    for _ in range(smooth_iters):
        cells = good_tris(pts)
        e = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [0, 2]]])
        e = np.unique(np.sort(e, axis=1), axis=0)
        vec = pts[e[:, 0]] - pts[e[:, 1]]
        L = np.maximum(np.linalg.norm(vec, axis=1), 1e-12)
        F = np.maximum(h0 - L, 0.0)  # repulsive only
        fvec = (F / L)[:, None] * vec
        force = np.zeros_like(pts)
        np.add.at(force, e[:, 0], fvec)
        np.add.at(force, e[:, 1], -fvec)
        force[:nb] = 0.0  # boundary points are fixed
        pts = pts + 0.2 * force
        # pull escaped interior points back inside
        if pts.shape[0] > nb:
            inter = pts[nb:]
            bad = ~_points_in_polygon(inter, boundary) | (
                _dist_to_polyline(inter, boundary) < 0.3 * h
            )
            if bad.any():
                keep = np.ones(pts.shape[0], dtype=bool)
                keep[nb:][bad] = False
                pts = pts[keep]

    cells = good_tris(pts)
    # drop unreferenced points (escapees removed above may leave orphans)
    used = np.zeros(pts.shape[0], dtype=bool)
    used[:nb] = True
    used[cells.reshape(-1)] = True
    remap = -np.ones(pts.shape[0], dtype=np.int64)
    remap[used] = np.arange(int(used.sum()))
    return pts[used], remap[cells]


def _orient_ccw(points: np.ndarray, cells: np.ndarray) -> np.ndarray:
    p = points[cells]
    det = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 2, 0] - p[:, 0, 0]
    ) * (p[:, 1, 1] - p[:, 0, 1])
    cells = cells.copy()
    flip = det < 0
    cells[flip] = cells[flip][:, [0, 2, 1]]
    return cells


def triangulate_regions(
    regions: dict,
    h: float,
    facet_groups: dict = None,
    vertex_groups: dict = None,
    smooth_iters: int = 25,
) -> Mesh:
    """
    Triangulate a multi-region planar B-rep into a tagged :class:`Mesh`.

    ``regions``: list of ``(name, loop)`` pairs where a loop is a list of
    (StepEdge, flipped) forming a closed boundary (a
    :class:`~.step_io.StepFace` ``.loop``).  Names may repeat (e.g. the
    reference's split-cover geometries map two faces to 'cover',
    ``genmesh_M5_CB.py:48-49``); shared edges (same eid) are discretized
    once, so region interfaces conform.

    ``facet_groups``: name -> list of edge ids; boundary mesh facets lying
    on those edges get a marker and a subdomain entry (gmsh physical-group
    semantics, reference ``meshes/genmesh_M5_CB.py:23-26``).

    ``vertex_groups``: name -> (2,) coordinates; the nearest mesh vertex
    gets a vertex marker (reference's 'separation-inf/mid/sup' points,
    ``genmesh_M5_CB.py:27-28``).
    """
    # 1. shared edge discretization + global point registry
    edge_pts = {}
    registry = {}
    coords = []

    def global_id(p):
        key = (round(float(p[0]), 9), round(float(p[1]), 9))
        gid = registry.get(key)
        if gid is None:
            gid = len(coords)
            registry[key] = gid
            coords.append((float(p[0]), float(p[1])))
        return gid

    region_items = list(regions.items()) if isinstance(regions, dict) else list(regions)
    all_edges = {}
    for _, loop in region_items:
        for edge, _ in loop:
            all_edges[edge.eid] = edge
    for eid, edge in all_edges.items():
        pts = edge_points(edge, h)
        edge_pts[eid] = np.array([global_id(p) for p in pts], dtype=np.int64)

    # 2. per-region meshing
    all_cells = []
    cell_markers = []
    region_markers = {}
    for name, _ in region_items:
        if name not in region_markers:
            region_markers[name] = len(region_markers) + 1
    for name, loop in region_items:
        marker = region_markers[name]
        bnd_ids = []
        for edge, flipped in loop:
            ids = edge_pts[edge.eid]
            if flipped:
                ids = ids[::-1]
            bnd_ids.extend(ids[:-1].tolist())
        bnd_ids = np.asarray(bnd_ids, dtype=np.int64)
        boundary = np.asarray([coords[i] for i in bnd_ids])
        if _polygon_signed_area(boundary) < 0:
            boundary = boundary[::-1]
            bnd_ids = bnd_ids[::-1]
        pts, cells = _triangulate_polygon(boundary, h, smooth_iters)
        nb = bnd_ids.shape[0]
        # map local -> global: boundary keeps ids, interior points are new
        local_to_global = np.empty(pts.shape[0], dtype=np.int64)
        local_to_global[:nb] = bnd_ids
        for i in range(nb, pts.shape[0]):
            local_to_global[i] = global_id(pts[i])
        g_cells = local_to_global[cells]
        all_cells.append(g_cells)
        cell_markers.append(np.full(g_cells.shape[0], marker, dtype=INT))

    coords_arr = np.asarray(coords, dtype=float)
    cells_arr = _orient_ccw(coords_arr, np.concatenate(all_cells, axis=0))
    mesh = Mesh(coords_arr, cells_arr.astype(INT))
    mesh.mesh_functions[2][:] = np.concatenate(cell_markers)
    mesh.subdomains[2].update(region_markers)

    # 3. facet groups: match boundary mesh facets to B-rep edge segments
    if facet_groups:
        # sorted vertex pair -> facet index
        facets = mesh.entities[1]
        pair_to_facet = {
            (int(min(a, b)), int(max(a, b))): i
            for i, (a, b) in enumerate(facets)
        }
        for marker, (name, eids) in enumerate(facet_groups.items(), start=1):
            for eid in eids:
                ids = edge_pts[eid]
                for a, b in zip(ids[:-1], ids[1:]):
                    f = pair_to_facet.get((int(min(a, b)), int(max(a, b))))
                    if f is not None:
                        mesh.mesh_functions[1][f] = marker
            mesh.subdomains[1][name] = marker

    # 4. vertex groups (nearest vertex to the named coordinate)
    if vertex_groups:
        for marker, (name, xy) in enumerate(vertex_groups.items(), start=1):
            vid = int(
                np.argmin(np.linalg.norm(coords_arr - np.asarray(xy), axis=1))
            )
            mesh.mesh_functions[0][vid] = marker
            mesh.subdomains[0][name] = marker

    return mesh
