"""
Residual definitions binding forms to meshes.

``FemResidual`` mirrors ``vf_fem_tpu.residuals.base.FemResidual``: a signed
sum of element forms bound to a mesh, its markers and Dirichlet BC specs,
compiled into batched element functions plus index arrays.  Every static
array lives on the residual's device from construction on.

``FunctionalResidual`` is the trivial holder for the 1D fluid residuals
(the JAX package's ``JaxResidual``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from .. import config
from ..fem import assembly, banded
from ..mesh.core import Mesh

DEFAULT_DIRICHLET_BC = {"state/u1": [(0.0, "facet", "fixed")]}


class FemResidual:
    """A signed sum of element forms over a mesh: F_u(u1, v1, a1; g, p)."""

    def __init__(
        self,
        signed_forms: Sequence[tuple],  # [(sign, BaseForm), ...]
        mesh: Mesh,
        traction_subdomains: Sequence[str] = ("pressure",),
        dirichlet_bc_specs: Optional[dict] = None,
        device=config.DEFAULT_DEVICE,
        dtype=config.DEFAULT_DTYPE,
    ):
        self._signed_forms = list(signed_forms)
        self._mesh = mesh
        self._traction_subdomains = tuple(traction_subdomains)
        self.device = config.model_device(device)
        self.dtype = dtype
        if dirichlet_bc_specs is None:
            dirichlet_bc_specs = DEFAULT_DIRICHLET_BC
        self._dirichlet_bc_specs = dirichlet_bc_specs

        self.topology = assembly.build_topology(
            mesh, traction_subdomains, self.device, dtype
        )

        # union of coefficient specs, in form order
        self.coefficient_spec: dict = {}
        for _, form in self._signed_forms:
            for key, spec in form.COEFFICIENT_SPEC.items():
                prev = self.coefficient_spec.setdefault(key, spec)
                if prev.space != spec.space:
                    raise ValueError(
                        f"Conflicting spaces for coefficient {key}:"
                        f" {prev.space} vs {spec.space}"
                    )
        self._cell_forms = [
            (s, f) for s, f in self._signed_forms if f.domain == "cell"
        ]
        self._facet_forms = [
            (s, f) for s, f in self._signed_forms if f.domain == "facet"
        ]

        # reference coordinates (a shape parameter adds prop/umesh on top)
        self.X_ref = torch.as_tensor(mesh.coords, dtype=dtype, device=self.device)

        subnames = [
            spec[2] for spec in self._dirichlet_bc_specs.get("state/u1", [])
        ]
        if subnames:
            self.bc_vertex_mask = assembly.dirichlet_vertex_mask(mesh, subnames)
        else:
            self.bc_vertex_mask = np.zeros(mesh.num_vertices, dtype=bool)
        dim = mesh.dim
        bc_verts = np.nonzero(self.bc_vertex_mask)[0]
        self.bc_dofs = (bc_verts[:, None] * dim + np.arange(dim)[None, :]).reshape(-1)

        # deterministic scatters of the plain cell pass and the facet pass
        cells = mesh.cells
        fcells = self.topology.facet_cells.cpu().numpy()
        self._cell_scatter = assembly.ScatterPlan(
            cells, mesh.num_vertices, self.device
        )
        self._facet_scatter = assembly.ScatterPlan(
            cells[fcells], mesh.num_vertices, self.device
        )
        # the banded plan, on the device, when the mesh admits one
        try:
            host_plan = banded.plan_banded(
                cells, mesh.num_vertices, gc=config.BANDED_GC
            )
            self._banded, self._banded_error = (
                banded.to_device(host_plan, self.device), None
            )
        except ValueError as err:
            self._banded, self._banded_error = None, str(err)

    # -- accessors ---------------------------------------------------------
    def mesh(self) -> Mesh:
        return self._mesh

    def n_facets(self) -> int:
        return int(self.topology.facet_cells.shape[0])

    def has_facet_pass(self) -> bool:
        return bool(self._facet_forms) and self.n_facets() > 0

    # -- coefficient plumbing ------------------------------------------------
    def coefficient_shape(self, key: str):
        spec = self.coefficient_spec[key]
        nvert, nc, dim = (
            self._mesh.num_vertices,
            self._mesh.num_cells,
            self._mesh.dim,
        )
        return {
            "cg1_vector": (nvert, dim),
            "cg1_scalar": (nvert,),
            "dg0_scalar": (nc,),
            "const_scalar": (1,),
            "const_vector": (dim,),
        }[spec.space]

    def default_coefficients(self) -> dict:
        """Global coefficient arrays (numpy) filled with spec defaults."""
        out = {}
        for key, spec in self.coefficient_spec.items():
            arr = np.full(self.coefficient_shape(key), float(spec.default))
            if spec.space == "const_vector" and key == "prop/ncontact":
                arr[:] = 0.0  # default contact normal +y
                arr[1] = 1.0
            out[key] = arr
        return out

    # -- element functions ---------------------------------------------------
    def cell_elem_fn(self) -> Callable:
        topo = self.topology
        cell_forms = self._cell_forms

        def cell_elem(Xe, local):
            geom = assembly.make_cell_geom(Xe, topo)
            res = None
            for sign, form in cell_forms:
                r = sign * form.cell_kernel(geom, local)
                res = r if res is None else res + r
            return res

        return cell_elem

    def facet_elem_fn(self) -> Callable:
        topo = self.topology
        facet_forms = self._facet_forms

        def facet_elem(Xe, sel, opp_sel, local):
            geom = assembly.make_facet_geom(Xe, sel, opp_sel, topo)
            res = None
            for sign, form in facet_forms:
                r = sign * form.facet_kernel(geom, local)
                res = r if res is None else res + r
            return res

        return facet_elem

    def _locals(self, fields: dict, vert_ids, cell_ids):
        """Per-element local values + ``vmap`` in_dims (0 or None)."""
        local, axes = {}, {}
        for key, spec in self.coefficient_spec.items():
            arr = fields[key]
            if spec.space in ("cg1_vector", "cg1_scalar"):
                local[key] = arr[vert_ids]
                axes[key] = 0
            elif spec.space == "dg0_scalar":
                local[key] = arr if cell_ids is None else arr[cell_ids]
                axes[key] = 0
            else:  # const
                local[key] = arr[0] if spec.space == "const_scalar" else arr
                axes[key] = None
        return local, axes

    def gather_cell_locals(self, fields: dict):
        return self._locals(fields, self.topology.cells, None)

    def gather_facet_locals(self, fields: dict):
        fcells = self.topology.facet_cells
        return self._locals(fields, self.topology.cells[fcells], fcells)

    # -- banded cell pass ----------------------------------------------------
    def banded_plan(self) -> banded.DevicePlan:
        """The banded-assembly plan on this residual's device; raises
        ``ValueError`` if the mesh is not bandwidth-ordered."""
        if self._banded is None:
            raise ValueError(self._banded_error)
        return self._banded

    def banded_ok(self) -> bool:
        return self._banded is not None

    def _cell_res_banded(self, fields: dict, X: torch.Tensor) -> torch.Tensor:
        """Cell pass through the banded kernels: one gather of all cg1
        channels and the coordinates, the element kernel on SoA locals
        (cell index last), one scatter."""
        plan = self.banded_plan()
        mesh = self._mesh
        nvert, dim = mesh.num_vertices, mesh.dim
        ncpad = plan.ncpad

        comps, layout = [], []
        for key, spec in self.coefficient_spec.items():
            if spec.space == "cg1_vector":
                comps.append(fields[key].reshape(nvert, dim).T)
                layout.append((key, dim))
            elif spec.space == "cg1_scalar":
                comps.append(fields[key].reshape(1, nvert))
                layout.append((key, 1))
        comps.append(X.T)
        layout.append(("__X__", dim))
        F = torch.cat(comps, dim=0)  # (C, nvert) channels-major
        loc_all = banded.banded_gather(plan, F)  # (nv, C, ncpad)

        # element kernels take the cell axis first: a permuted view keeps
        # every per-element scalar a contiguous (ncpad,) vector
        local = {}
        c0 = 0
        Xe = None
        for key, ncols in layout:
            v = loc_all[:, c0 : c0 + ncols, :].permute(2, 0, 1)
            c0 += ncols
            if key == "__X__":
                Xe = v
            else:
                local[key] = v if ncols > 1 else v[..., 0]
        for key, spec in self.coefficient_spec.items():
            arr = fields[key]
            if spec.space == "dg0_scalar":
                pad = arr[-1:].expand(ncpad - arr.shape[0])
                local[key] = torch.cat([arr, pad])
            elif spec.space == "const_scalar":
                local[key] = arr[0]
            elif spec.space == "const_vector":
                local[key] = arr

        res_c = self.cell_elem_fn()(Xe, local)  # (ncpad, nv, dim)
        res_cm = banded.banded_scatter(
            plan, res_c.permute(1, 2, 0).contiguous(), nvert
        )  # (dim, nvert)
        return res_cm.T

    def assemble_res(self, fields: dict, banded: bool = False) -> torch.Tensor:
        """(nvert, dim) residual of the 'u' form given all coefficient
        fields; no BCs.  ``banded`` routes the cell pass through the banded
        gather/scatter kernels."""
        topo = self.topology
        X = self.X_ref
        if "prop/umesh" in fields:
            X = X + fields["prop/umesh"]

        if banded:
            res = self._cell_res_banded(fields, X)
        else:
            local, _ = self.gather_cell_locals(fields)
            res_c = self.cell_elem_fn()(X[topo.cells], local)
            res = self._cell_scatter(res_c)

        if self.has_facet_pass():
            flocal, _ = self.gather_facet_locals(fields)
            cell_verts = topo.cells[topo.facet_cells]
            res_f = self.facet_elem_fn()(
                X[cell_verts], topo.facet_sel, topo.facet_opp_sel, flocal
            )
            res = res + self._facet_scatter(res_f)
        return res


    # -- generic dense Jacobians ---------------------------------------------
    def _wrt_cols(self, wrt_key: str):
        """The column count of ``d res / d fields[wrt_key]`` and each cell's
        and each facet cell's column indices (the JAX package's
        ``_wrt_cols``)."""
        space = self.coefficient_spec[wrt_key].space
        mesh, topo = self._mesh, self.topology
        dim, nc = mesh.dim, mesh.num_cells
        cells = mesh.cells
        fcells = topo.facet_cells.cpu().numpy()
        if space == "cg1_vector":
            ncols = mesh.num_vertices * dim
            cdofs = assembly.cell_dof_array(cells, dim)
            fdofs = assembly.cell_dof_array(cells[fcells], dim)
        elif space == "cg1_scalar":
            ncols, cdofs, fdofs = mesh.num_vertices, cells, cells[fcells]
        elif space == "dg0_scalar":
            ncols, cdofs, fdofs = nc, np.arange(nc)[:, None], fcells[:, None]
        elif space == "const_scalar":
            ncols = 1
            cdofs = np.zeros((nc, 1), dtype=np.int64)
            fdofs = np.zeros((len(fcells), 1), dtype=np.int64)
        else:  # const_vector
            ncols = dim
            cdofs = np.tile(np.arange(dim), (nc, 1))
            fdofs = np.tile(np.arange(dim), (len(fcells), 1))
        dev = self.device
        return (ncols, torch.as_tensor(cdofs, dtype=torch.int64, device=dev),
                torch.as_tensor(fdofs, dtype=torch.int64, device=dev))

    def assemble_jac_dense(self, fields: dict, wrt_key: str,
                           tangent_fields: Optional[dict] = None) -> torch.Tensor:
        """Dense Jacobian ``d res / d fields[wrt_key]`` of the assembled 'u'
        residual, (nvert*dim, ncols), by element-level ``jacfwd`` and a
        scatter-add (the JAX package's ``assemble_jac_dense``).  With
        ``tangent_fields`` (the same keys as ``fields``) it differentiates
        the linearized residual ``jvp(res, fields, tangent_fields)``
        instead, the blocks of the linearized dynamical models.  No
        Dirichlet handling: callers mask rows as they need.  With a shape
        parameter ``prop/umesh`` each element's coordinates are the
        reference plus ``umesh``, so the Jacobian with respect to it
        includes the geometry's."""
        mesh, topo = self._mesh, self.topology
        dim = mesh.dim
        ndof = mesh.num_vertices * dim
        has_shape = "prop/umesh" in self.coefficient_spec
        ncols, cdofs, fdofs = self._wrt_cols(wrt_key)
        out = torch.zeros((ndof, ncols), dtype=self.dtype, device=self.device)

        def add(elem, Xref_e, rows, cols, gather, *extra):
            local, axes = gather(fields)

            def res_of(loc, Xref, ex):
                X = Xref + loc["prop/umesh"] if has_shape else Xref
                return elem(X, *ex, loc)

            if tangent_fields is None:
                def elem_res(w, Xref, loc, *ex):
                    return res_of({**loc, wrt_key: w}, Xref, ex)

                args, in_dims = (local,), (axes,)
            else:
                tlocal, _ = gather(tangent_fields)

                def elem_res(w, Xref, loc, tloc, *ex):
                    # the linearized residual: jvp along the tangent locals
                    return jvp(lambda l: res_of(l, Xref, ex),
                               ({**loc, wrt_key: w},), (tloc,))[1]

                args, in_dims = (local, tlocal), (axes, axes)
            J = vmap(jacfwd(elem_res),
                     in_dims=(axes[wrt_key], 0) + in_dims + (0,) * len(extra))(
                local[wrt_key], Xref_e, *args, *extra)
            ne, nld = rows.shape
            J = J.reshape(ne, nld, -1)
            idx = (rows[:, :, None].expand(J.shape), cols[:, None, :].expand(J.shape))
            out.index_put_(idx, J, accumulate=True)

        cells = topo.cells
        row_c = torch.as_tensor(assembly.cell_dof_array(mesh.cells, dim), device=self.device)
        add(self.cell_elem_fn(), self.X_ref[cells], row_c, cdofs,
            self.gather_cell_locals)
        if self.has_facet_pass():
            fcells = topo.facet_cells
            row_f = torch.as_tensor(
                assembly.cell_dof_array(mesh.cells[fcells.cpu().numpy()], dim),
                device=self.device)
            add(self.facet_elem_fn(), self.X_ref[cells[fcells]], row_f, fdofs,
                self.gather_facet_locals, topo.facet_sel, topo.facet_opp_sel)
        return out


class FunctionalResidual:
    """Holder of a residual callable ``res(state, control, prop)`` and its
    prototype (numpy) arguments."""

    def __init__(self, res: Callable, res_args: tuple):
        self.res = res
        self.res_args = res_args
