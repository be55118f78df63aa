"""
Host-side mesh data structures.

The reference delegates meshing to dolfin ``Mesh``/``MeshFunction`` objects
(C++) plus gmsh physical groups (reference: ``src/femvf/meshutils.py:63-166``).
Here a mesh is a plain collection of numpy arrays — coordinates, cell
connectivity, per-dimension entity lists and integer markers — produced on
the host once and shipped to the device as static arrays.  All simplex
topology (edges, facets, boundary adjacency) is derived with vectorized
numpy; nothing here touches the device.

Conventions
-----------
- Simplex meshes only: triangles (2D) and tetrahedra (3D), P1 geometry.
- DOF ordering for CG1 vector fields is vertex-major interleaved:
  ``dof(vertex v, component c) = v*dim + c``.  Scalar CG1 fields are indexed
  by vertex; DG0 fields by cell.  (The reference gets the same effect through
  ``dfn.vertex_to_dof_map``, e.g. ``src/femvf/models/transient.py:355-359``.)
- ``mesh_functions[d]`` is an int array of markers over all entities of
  dimension ``d``; ``subdomains[d]`` maps subdomain names to marker values
  (mirrors dolfin ``MeshFunction`` + gmsh physical-group dicts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

INT = np.int32


def _unique_entities(vertex_tuples: np.ndarray):
    """
    Return (unique_entities, inverse) where entities are sorted vertex tuples.

    ``vertex_tuples``: (n, k) int array, possibly with duplicates.
    """
    sorted_tuples = np.sort(vertex_tuples, axis=1)
    uniq, inverse = np.unique(sorted_tuples, axis=0, return_inverse=True)
    return uniq.astype(INT), inverse.reshape(vertex_tuples.shape[0], -1)


# Local facet enumeration: facet i of a simplex is opposite local vertex i.
_TRI_FACETS = np.array([[1, 2], [0, 2], [0, 1]], dtype=INT)
_TET_FACETS = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=INT)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=INT
)


def _cell_facets(cells: np.ndarray) -> np.ndarray:
    """Return (n_cells, n_local_facets, dim) local facet vertex tuples."""
    dim = cells.shape[1] - 1
    local = _TRI_FACETS if dim == 2 else _TET_FACETS
    return cells[:, local]


@dataclass
class Mesh:
    """A simplex mesh with per-dimension entities and markers."""

    coords: np.ndarray  # (n_vertices, dim) float64
    cells: np.ndarray  # (n_cells, dim+1) int

    # Derived topology (filled by __post_init__)
    entities: dict = field(default_factory=dict)  # dim -> (n_ent, k) vertex ids
    mesh_functions: dict = field(default_factory=dict)  # dim -> (n_ent,) int
    subdomains: dict = field(default_factory=dict)  # dim -> {name: marker}

    # Boundary facet topology
    boundary_facets: np.ndarray = None  # (n_bf,) facet ids
    facet_to_cell: np.ndarray = None  # (n_facets,) adjacent cell (boundary: the one)
    facet_opposite_local_vertex: np.ndarray = None  # (n_facets,) local idx in cell

    def __post_init__(self):
        self.coords = np.asarray(self.coords, dtype=np.float64)
        self.cells = np.asarray(self.cells, dtype=INT)
        dim = self.dim
        nv = self.coords.shape[0]

        # Entities by dimension
        self.entities[0] = np.arange(nv, dtype=INT).reshape(-1, 1)
        self.entities[dim] = self.cells

        # Facets (dim-1) with cell adjacency, by sorting vertex tuples.
        # (The JAX package may take a hashed C++ path here instead; the
        # two agree up to facet ordering, and each mesh is self-consistent.)
        cf = _cell_facets(self.cells)  # (nc, nlf, dim)
        nc, nlf, k = cf.shape
        flat = cf.reshape(-1, k)
        facets, inverse = _unique_entities(flat)
        inverse = inverse.reshape(nc, nlf)
        self.entities[dim - 1] = facets

        n_facets = facets.shape[0]
        counts = np.zeros(n_facets, dtype=INT)
        np.add.at(counts, inverse.reshape(-1), 1)
        self.boundary_facets = np.nonzero(counts == 1)[0].astype(INT)

        # adjacency: one incident cell and the local facet idx per facet
        facet_cell = np.full(n_facets, -1, dtype=INT)
        facet_local = np.full(n_facets, -1, dtype=INT)
        cell_ids = np.repeat(np.arange(nc, dtype=INT), nlf)
        local_ids = np.tile(np.arange(nlf, dtype=INT), nc)
        facet_cell[inverse.reshape(-1)] = cell_ids
        facet_local[inverse.reshape(-1)] = local_ids
        self.facet_to_cell = facet_cell
        # facet i of the cell is opposite local vertex i
        self.facet_opposite_local_vertex = facet_local

        # Edges (dim 1); in 2D edges == facets
        if dim == 3:
            ce = self.cells[:, _TET_EDGES].reshape(-1, 2)
            edges, _ = _unique_entities(ce)
            self.entities[1] = edges
        # In 2D, entities[1] was set as facets above.

        # Default mesh functions (all zeros) and empty subdomain dicts
        for d, ents in self.entities.items():
            if d not in self.mesh_functions:
                self.mesh_functions[d] = np.zeros(ents.shape[0], dtype=INT)
            if d not in self.subdomains:
                self.subdomains[d] = {}

    # -- Basic properties ---------------------------------------------------
    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def facets(self) -> np.ndarray:
        return self.entities[self.dim - 1]

    # -- Marking -------------------------------------------------------------
    def mark_entities(
        self,
        dim: int,
        predicate: Callable[[np.ndarray, np.ndarray], np.ndarray],
        value: int,
        name: Optional[str] = None,
        boundary_only: bool = False,
    ):
        """
        Mark entities of dimension ``dim`` where ``predicate`` is true.

        ``predicate(midpoints, vertex_coords)`` receives entity midpoints
        ``(n, gdim)`` and per-entity vertex coordinates ``(n, k, gdim)`` and
        returns a boolean mask.  Mirrors dolfin ``SubDomain.mark``.
        """
        ents = self.entities[dim]
        vcoords = self.coords[ents]  # (n, k, gdim)
        mids = vcoords.mean(axis=1)
        mask = np.asarray(predicate(mids, vcoords), dtype=bool)
        if boundary_only and dim == self.dim - 1:
            bmask = np.zeros(ents.shape[0], dtype=bool)
            bmask[self.boundary_facets] = True
            mask = mask & bmask
        self.mesh_functions[dim][mask] = value
        if name is not None:
            self.subdomains[dim][name] = value
        return mask

    def entities_by_marker(self, dim: int, values) -> np.ndarray:
        """Return entity indices of dimension ``dim`` with markers in ``values``."""
        if np.isscalar(values):
            values = {int(values)}
        mf = self.mesh_functions[dim]
        mask = np.isin(mf, list(values))
        return np.nonzero(mask)[0].astype(INT)

    def facets_by_subdomain(self, names: Sequence[str]) -> np.ndarray:
        sub = self.subdomains[self.dim - 1]
        values = {sub[name] for name in names}
        facets = self.entities_by_marker(self.dim - 1, values)
        # restrict to boundary facets
        bset = np.zeros(self.facets.shape[0], dtype=bool)
        bset[self.boundary_facets] = True
        return facets[bset[facets]]

    # -- element type helpers (``mesh.dofmaps``) -----------------------------
    def element_type_dim(self, element_type) -> int:
        if isinstance(element_type, (int, np.integer)):
            return int(element_type)
        mapping = {
            "vertex": 0,
            "edge": 1,
            "facet": self.dim - 1,
            "cell": self.dim,
        }
        return mapping[element_type]


def vertices_from_edges(edges: np.ndarray) -> np.ndarray:
    """Unique vertex ids touched by a set of edges (edge->vertex array)."""
    return np.unique(np.asarray(edges).reshape(-1))


def sort_vertices_by_nearest_neighbours(
    vertex_coordinates: np.ndarray, origin: Optional[np.ndarray] = None
) -> np.ndarray:
    """
    Permutation sorting points in successive nearest-neighbour order from an
    origin (reference: ``src/femvf/meshutils.py:295-334``).  Used to orient
    1D fluid interface meshes along increasing arc length.
    """
    coords = np.asarray(vertex_coordinates, dtype=float)
    if origin is None:
        origin = np.zeros(coords.shape[-1])

    idx_sort = [int(np.argmin(np.linalg.norm(coords - origin, axis=-1)))]
    dist = np.empty(coords.shape[0])
    while len(idx_sort) < coords.shape[0]:
        d = coords - coords[idx_sort[-1]]
        dist[:] = np.sqrt(np.sum(d**2, axis=-1))
        dist[idx_sort] = np.nan
        idx_sort.append(int(np.nanargmin(dist)))
    return np.array(idx_sort, dtype=INT)
