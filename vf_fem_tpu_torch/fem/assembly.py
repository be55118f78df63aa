"""
Global assembly: gather -> batched element kernels -> scatter-add.

Counterpart of ``vf_fem_tpu.fem.assembly``.  All static index arrays are
built on the host with numpy and moved to the model's device once.

Scatter-adds (residual facet pass, plain cell pass, dense Jacobian, the
element-by-element operator and its block-Jacobi diagonal, the
block-banded fill) go through :class:`ScatterPlan`: a host-built
transpose of the scatter pattern that turns the scatter into a gather
plus a row sum in a fixed order.  ``index_add_``/``index_put_(accumulate=True)`` on CUDA use atomics
whose order changes from run to run; the f64 goldens are held at 1e-8
over whole trajectories, so every sum here is taken in the same order on
every device and every run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import ops
from ..mesh.core import Mesh
from . import elements
from .forms import CellGeom, FacetGeom, facet_restrict


class Topology(NamedTuple):
    """Static index arrays and quadrature tables, on the model's device."""

    dim: int
    n_vertices: int
    n_cells: int
    cells: torch.Tensor  # (nc, nv) int64
    # marked (traction-subdomain) boundary facets:
    facet_cells: torch.Tensor  # (nf,) adjacent cell index
    facet_sel: torch.Tensor  # (nf, nv, dimf) one-hot facet-vertex selectors
    facet_opp_sel: torch.Tensor  # (nf, nv) one-hot opposite-vertex selector
    cell_bary: torch.Tensor
    cell_qw: torch.Tensor
    facet_bary: torch.Tensor
    facet_qw: torch.Tensor


def build_topology(
    mesh: Mesh,
    traction_subdomains: Sequence[str],
    device,
    dtype,
) -> Topology:
    dim = mesh.dim
    cells = np.asarray(mesh.cells)

    try:
        marked = mesh.facets_by_subdomain(traction_subdomains)
    except KeyError:
        marked = np.zeros(0, dtype=np.int32)

    fcell = mesh.facet_to_cell[marked]
    fopp = mesh.facet_opposite_local_vertex[marked]
    # local indices of each facet vertex within the adjacent cell
    facet_verts = mesh.facets[marked]  # (nf, dim) global vertex ids
    cell_verts = cells[fcell]  # (nf, nv)
    floc = np.argmax(cell_verts[:, None, :] == facet_verts[:, :, None], axis=-1)

    nv = dim + 1
    nf = len(marked)
    facet_sel = np.zeros((nf, nv, dim))
    facet_opp_sel = np.zeros((nf, nv))
    rows = np.arange(nf)
    for q in range(dim):
        facet_sel[rows, floc[:, q], q] = 1.0
    facet_opp_sel[rows, fopp] = 1.0

    cb, cw = elements.cell_quadrature(dim)
    fb, fw = elements.facet_quadrature(dim)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return Topology(
        dim=dim,
        n_vertices=mesh.num_vertices,
        n_cells=cells.shape[0],
        cells=i(cells),
        facet_cells=i(fcell),
        facet_sel=f(facet_sel),
        facet_opp_sel=f(facet_opp_sel),
        cell_bary=f(cb),
        cell_qw=f(cw),
        facet_bary=f(fb),
        facet_qw=f(fw),
    )


def make_cell_geom(X_e: torch.Tensor, topo: Topology) -> CellGeom:
    grads, vol = elements.cell_shape_gradients(X_e)
    return CellGeom(
        X=X_e, grads=grads, vol=vol, bary=topo.cell_bary, qw=topo.cell_qw
    )


def make_facet_geom(
    X_e: torch.Tensor, sel: torch.Tensor, opp_sel: torch.Tensor,
    topo: Topology,
) -> FacetGeom:
    grads, _ = elements.cell_shape_gradients(X_e)
    Xf = facet_restrict(X_e, sel)  # (..., dimf, dim) facet vertex coords
    X_opp = torch.einsum("...v,...vi->...i", opp_sel, X_e)
    meas, normal = elements.facet_measure_normal(Xf, X_opp)
    return FacetGeom(
        X=X_e, grads=grads, meas=meas, normal=normal,
        fbary=topo.facet_bary, fqw=topo.facet_qw, sel=sel,
    )


class ScatterPlan:
    """Deterministic scatter-add of per-element values into a global array.

    ``index`` (ne, k): the global row each element value goes to.  At build
    time the pattern is transposed: for each touched row, the positions of
    its contributions in element order, padded to a common width with a
    pointer to a zero slot.  ``plan(values)`` then sums each row's
    contributions in that fixed order, with no atomics.
    """

    def __init__(self, index: np.ndarray, n_out: int, device):
        flat = np.asarray(index).reshape(-1).astype(np.int64)
        n_src = flat.size
        order = np.argsort(flat, kind="stable")
        sorted_rows = flat[order]
        targets, first, counts = np.unique(
            sorted_rows, return_index=True, return_counts=True
        )
        width = int(counts.max()) if n_src else 1
        table = np.full((targets.size, width), n_src, dtype=np.int64)
        slot = np.arange(n_src) - np.repeat(first, counts)
        table[np.repeat(np.arange(targets.size), counts), slot] = order
        self.n_src = n_src
        self.n_out = int(n_out)
        self.targets = torch.as_tensor(targets, device=device)
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` (ne, k, *trail) -> (n_out, *trail)."""
        trail = values.shape[2:]
        src = values.reshape((self.n_src,) + trail)
        src = torch.cat([src, src.new_zeros((1,) + trail)])
        summed = src[self.table].sum(1)
        out = values.new_zeros((self.n_out,) + trail)
        out[self.targets] = summed
        return out


def cell_dof_array(cells: np.ndarray, dim: int) -> np.ndarray:
    """(nc, nv*dim) global dof indices, vertex-major interleaved ordering."""
    nc, nv = cells.shape
    dofs = np.asarray(cells)[:, :, None] * dim + np.arange(dim)[None, None, :]
    return dofs.reshape(nc, nv * dim)


def dense_jacobian_plan(dofs_arrays: Sequence[np.ndarray], ndof: int, device):
    """:class:`ScatterPlan` of element blocks (ne, nld, nld) into the
    flattened dense (ndof*ndof,) matrix; ``dofs_arrays`` are stacked in the
    order their blocks are concatenated (cells, then facets)."""
    keys = [
        (d[:, :, None] * ndof + d[:, None, :]).reshape(d.shape[0], -1)
        for d in dofs_arrays
    ]
    return ScatterPlan(np.concatenate(keys, axis=0), ndof * ndof, device)


def scatter_dense_jacobian(plan: ScatterPlan, blocks: Sequence[torch.Tensor],
                           ndof: int) -> torch.Tensor:
    """Assemble element blocks (each (ne, nld, nld)) into a dense matrix."""
    J = torch.cat([b.reshape(b.shape[0], -1) for b in blocks], dim=0)
    return plan(J).reshape(ndof, ndof)


class EBEPlans(NamedTuple):
    """Host-built scatter plans of the element-by-element operator, over
    the cell elements and then the facet elements."""

    dofs: ScatterPlan  # element dofs (ne, nld) -> (ndof,): the matvec
    nodes: ScatterPlan  # element vertices (ne, nv) -> (nvert,): the
    # nodal diagonal blocks of block-Jacobi


def ebe_plans(cells_arrays: Sequence[np.ndarray], nvert: int, dim: int,
              device) -> EBEPlans:
    """Plans for the elements with vertex arrays ``cells_arrays`` (cells,
    then the facets' cells), in that order."""
    cells = np.concatenate(cells_arrays, axis=0)
    return EBEPlans(
        dofs=ScatterPlan(cell_dof_array(cells, dim), nvert * dim, device),
        nodes=ScatterPlan(cells, nvert, device),
    )


class EBEOperator(NamedTuple):
    """Element-by-element linear operator (counterpart of
    ``vf_fem_tpu.fem.assembly.EBEOperator``): ``matvec(x)`` =
    scatter(J_e @ x[dofs_e]) with identity Dirichlet rows.  The element
    products run through ``ops.ebe_matvec`` (kernel K3 on CUDA), cells
    first and facets second; the scatters are the deterministic plans of
    ``plans``."""

    J_cells: torch.Tensor  # (nc, nld, nld)
    cell_dofs: torch.Tensor  # (nc, nld) int64
    J_facets: Optional[torch.Tensor]  # (nf, nld, nld) or None
    facet_dofs: Optional[torch.Tensor]  # (nf, nld) int64 or None
    bc_dofs: torch.Tensor  # (n_bc,) int64
    plans: EBEPlans

    def _parts(self):
        parts = [(self.J_cells, self.cell_dofs)]
        if self.J_facets is not None:
            parts.append((self.J_facets, self.facet_dofs))
        return parts

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        ys = [ops.ebe_matvec(J, x, d) for J, d in self._parts()]
        y = self.plans.dofs(torch.cat(ys))
        y[self.bc_dofs] = x[self.bc_dofs]
        return y

    def matvec_transpose(self, x: torch.Tensor) -> torch.Tensor:
        """``A^T x`` (the adjoint solves): x zeroed on the Dirichlet dofs,
        each element block transposed (``ops.ebe_matvec_t``, kernel K3T on
        CUDA; cells, then facets), the same scatter as :meth:`matvec`, then
        ``x`` added back on the Dirichlet dofs, whose identity rows become
        identity columns."""
        xm = x.clone()
        xm[self.bc_dofs] = 0.0
        ys = [ops.ebe_matvec_t(J, xm, d) for J, d in self._parts()]
        y = self.plans.dofs(torch.cat(ys))
        y[self.bc_dofs] += x[self.bc_dofs]
        return y

    def block_diag_inverse(self, dim: int) -> torch.Tensor:
        """Inverse of the nodal ``dim x dim`` diagonal blocks,
        (ndof/dim, dim, dim): each element's vertex-diagonal blocks summed
        per vertex, Dirichlet rows and columns made identity, inverted in
        closed form (``elements.inv_small``: 2x2 or 3x3)."""
        diag = []
        for J, _ in self._parts():
            ne, nld, _ = J.shape
            J5 = J.reshape(ne, nld // dim, dim, nld // dim, dim)
            # (ne, dim, dim, nv) -> (ne, nv, dim, dim)
            diag.append(torch.diagonal(J5, dim1=1, dim2=3).permute(0, 3, 1, 2))
        D = self.plans.nodes(torch.cat(diag))
        nodes = self.bc_dofs // dim
        comps = self.bc_dofs % dim
        D[nodes, comps, :] = 0.0
        D[nodes, :, comps] = 0.0
        D[nodes, comps, comps] = 1.0
        return elements.inv_small(D)


def block_jacobi_apply(Dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Nodal block-Jacobi preconditioner: ``Dinv[n] @ r[n]`` per node."""
    block = Dinv.shape[-1]
    return torch.einsum("nij,nj->ni", Dinv, r.reshape(-1, block)).reshape(-1)


def apply_dirichlet_rows(A: torch.Tensor, bc_dofs: torch.Tensor) -> torch.Tensor:
    """Zero Dirichlet rows and put 1 on their diagonal (in place)."""
    if bc_dofs.shape[0] == 0:
        return A
    A[bc_dofs, :] = 0.0
    A[bc_dofs, bc_dofs] = 1.0
    return A


def dirichlet_vertex_mask(
    mesh: Mesh, subdomain_names: Sequence[str] = ("fixed",)
) -> np.ndarray:
    """Boolean (n_vertices,) mask of vertices on named facet subdomains."""
    facets = mesh.facets_by_subdomain(subdomain_names)
    verts = np.unique(mesh.facets[facets].reshape(-1))
    mask = np.zeros(mesh.num_vertices, dtype=bool)
    mask[verts] = True
    return mask
