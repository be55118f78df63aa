"""
Dynamical (first-order) models for linearization and Hopf analysis
(counterpart of ``vf_fem_tpu.models.dynamical``).

A model is the residual ``F(x, xt; g, p)`` in first-order form with ``x =
(u, v)`` for the solid (``(q, p)`` for the fluid):

- solid: ``Fu(x, xt, g, p)`` is the 'u' form with ``u1 = u, v1 = v, a1 =
  vt``; ``Fv = v - ut``;
- fluid: the quasi-steady residual, without ``xt``;
- coupled: the solid and the fluid, the fluid's area from the solid's
  ``u`` and the solid's pressure from the fluid's ``p``.

Vectors (``state``, ``statet``, ``control``, ``prop`` and the linearized
models' ``dstate``, ``dstatet``, ``dcontrol``) are ``{label: tensor}``
dicts on the model's device, in the JAX package's block order; block
matrices are ``{(row_label, col_label): tensor}`` dicts in row-major block
order, made into one matrix by :func:`to_mono`.  The ``set_*`` methods
take dicts of numpy arrays or tensors.  Every block is ``jacfwd``/``jvp``
of the same pure residual functions (``FemResidual.assemble_jac_dense``,
dense); the large-mesh Hopf solver takes the solid's pencil banded
(:meth:`_BaseSolidDynamical.assem_banded_state_blocks`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from ..convert import to_tensors
from ..residuals.base import FemResidual, FunctionalResidual
from ..solvers import bsb
from .fsi import FSIMap
from .transient import (SolidElements, _contact_traction, area_from_surface,
                        pressure_to_solid)

__all__ = [
    "to_mono", "BaseDynamicalModel", "BaseLinearizedDynamicalModel",
    "SolidDynamicalModel", "LinearizedSolidDynamicalModel",
    "FluidDynamicalModel", "LinearizedFluidDynamicalModel",
    "FSIDynamicalModel", "LinearizedFSIDynamicalModel",
]


def to_mono(blocks: dict) -> torch.Tensor:
    """A block vector ``{label: tensor}`` as one vector, or a block matrix
    ``{(row, col): tensor}`` as one matrix, blocks in the dict's order
    (rows and columns in the order of their first appearance)."""
    keys = list(blocks)
    if keys and isinstance(keys[0], tuple):
        rows = list(dict.fromkeys(k[0] for k in keys))
        cols = list(dict.fromkeys(k[1] for k in keys))
        return torch.cat([torch.cat([blocks[r, c] for c in cols], dim=1)
                          for r in rows], dim=0)
    return torch.cat([v.reshape(-1) for v in blocks.values()])


def _assign(dst: dict, src: dict):
    """``dst[k] <- src[k]`` for every block of ``dst`` (as tensors of its
    blocks' device, dtype and shape)."""
    for k, old in dst.items():
        v = src[k]
        if isinstance(v, torch.Tensor):
            v = v.to(device=old.device, dtype=old.dtype)
        else:
            v = torch.as_tensor(np.asarray(v), dtype=old.dtype, device=old.device)
        dst[k] = v.reshape(old.shape).clone()


def _zeros_like(d: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in d.items()}


class BaseDynamicalModel:
    """The interface of a dynamical model."""

    def set_state(self, state):
        raise NotImplementedError()

    def set_statet(self, statet):
        raise NotImplementedError()

    def set_control(self, control):
        raise NotImplementedError()

    def set_prop(self, prop):
        raise NotImplementedError()

    def assem_res(self):
        raise NotImplementedError()

    def assem_dres_dstate(self):
        raise NotImplementedError()

    def assem_dres_dstatet(self):
        raise NotImplementedError()

    def assem_dres_dcontrol(self):
        raise NotImplementedError()

    def assem_dres_dprop(self):
        raise NotImplementedError()


class BaseLinearizedDynamicalModel(BaseDynamicalModel):
    def set_dstate(self, dstate):
        raise NotImplementedError()

    def set_dstatet(self, dstatet):
        raise NotImplementedError()

    def set_dcontrol(self, dcontrol):
        raise NotImplementedError()


# -- solid ----------------------------------------------------------------------


class _BaseSolidDynamical(SolidElements):
    def __init__(self, residual: FemResidual):
        self._residual = residual
        R = residual
        mesh = R.mesh()
        self.device, self.dtype = R.device, R.dtype
        self.nvert, self.dim = mesh.num_vertices, mesh.dim
        self.ndof = self.nvert * self.dim

        def z(n):
            return torch.zeros(n, dtype=self.dtype, device=self.device)

        self.state = {"u": z(self.ndof), "v": z(self.ndof)}
        self.statet = {"u": z(self.ndof), "v": z(self.ndof)}
        self.control = {"p": z(self.nvert)}
        spec = R.coefficient_spec
        defaults = R.default_coefficients()
        self.prop = to_tensors(
            {key.split("/", 1)[1]: defaults[key].reshape(-1)
             for key in spec if key.startswith("prop/")},
            self.device, self.dtype)
        self._prop_keys = list(self.prop)
        self._has_contact = "control/tcontact" in spec
        self._has_p1 = "control/p1" in spec
        self._init_elements()

    @property
    def residual(self) -> FemResidual:
        return self._residual

    def set_state(self, state):
        _assign(self.state, state)

    def set_statet(self, statet):
        _assign(self.statet, statet)

    def set_control(self, control):
        _assign(self.control, control)

    def set_prop(self, prop):
        _assign(self.prop, prop)

    # -- fields ----------------------------------------------------------------
    def _prop_fields(self) -> dict:
        out = {}
        for key, sp in self._residual.coefficient_spec.items():
            group, name = key.split("/", 1)
            if group == "prop":
                arr = self.prop[name]
                if sp.space == "cg1_vector":
                    arr = arr.reshape(self.nvert, self.dim)
                out[key] = arr
        return out

    def _coords(self, prop_fields: dict) -> torch.Tensor:
        X = self._residual.X_ref
        if "prop/umesh" in prop_fields:
            X = X + prop_fields["prop/umesh"]
        return X

    def _traction(self, prop_fields: dict):
        """The contact traction as a function of the nodal u (nvert, dim)."""
        X = self._coords(prop_fields)
        n = prop_fields["prop/ncontact"]
        y, k = prop_fields["prop/ycontact"][0], prop_fields["prop/kcontact"][0]
        return lambda u: _contact_traction(u, X, n, y, k)

    def _fields(self) -> dict:
        """All coefficient fields at the current (state, statet, control)."""
        fields = self._prop_fields()
        shape = (self.nvert, self.dim)
        u = self.state["u"].reshape(shape)
        fields["state/u1"] = u
        fields["state/v1"] = self.state["v"].reshape(shape)
        fields["state/a1"] = self.statet["v"].reshape(shape)
        if self._has_p1:
            fields["control/p1"] = self.control["p"]
        if self._has_contact:
            fields["control/tcontact"] = self._traction(fields)(u)
        return fields

    def _tangent_fields(self, dstate, dstatet, dcontrol) -> dict:
        """Tangent coefficient fields of the linearized residual; the
        contact traction's tangent is ``d(tcontact)/du . du``."""
        fields = self._fields()
        out = _zeros_like(fields)
        shape = (self.nvert, self.dim)
        du = dstate["u"].reshape(shape)
        out["state/u1"] = du
        out["state/v1"] = dstate["v"].reshape(shape)
        out["state/a1"] = dstatet["v"].reshape(shape)
        if self._has_p1:
            out["control/p1"] = dcontrol["p"]
        if self._has_contact:
            out["control/tcontact"] = jvp(self._traction(fields),
                                          (fields["state/u1"],), (du,))[1]
        return out

    # -- residual and Jacobians --------------------------------------------------
    def _resu(self) -> torch.Tensor:
        return self._residual.assemble_res(self._fields()).reshape(-1)

    def _jac(self, wrt_key: str, tangent=None) -> torch.Tensor:
        return self._residual.assemble_jac_dense(self._fields(), wrt_key,
                                                 tangent_fields=tangent)

    def _jac_u_with_contact(self, tangent=None) -> torch.Tensor:
        """dFu/du with the contact-traction chain rule ``dF/dtc . dtc/du``;
        ``dtc/du`` is block diagonal (a vertex's traction depends on its
        own u), applied vertex by vertex."""
        A = self._jac("state/u1", tangent)
        if self._has_contact:
            fields = self._fields()
            dF_dtc = self._residual.assemble_jac_dense(
                fields, "control/tcontact", tangent_fields=tangent)
            pf = {k: v for k, v in fields.items() if k.startswith("prop/")}
            X = self._coords(pf)
            n = pf["prop/ncontact"]
            y, k = pf["prop/ycontact"][0], pf["prop/kcontact"][0]
            Jv = vmap(jacfwd(lambda u_v, X_v: _contact_traction(u_v, X_v, n, y, k)))(
                fields["state/u1"], X)  # (nvert, dim, dim)
            n_, d_ = self.nvert, self.dim
            A = A + torch.einsum("rvi,vij->rvj", dF_dtc.reshape(self.ndof, n_, d_),
                                 Jv).reshape(self.ndof, self.ndof)
        return A

    # -- banded (large-mesh) pencil blocks -----------------------------------------
    def assem_banded_state_blocks(self, bsb_plan=None):
        """Banded first-order Jacobian blocks at the current state, ``(plan,
        K, D, M)``: ``K = dFu/du`` (with the contact-traction chain inside
        the facet ``jacfwd``; identity Dirichlet rows), ``D = dFu/dv`` and
        ``M = dFu/dvt`` (Dirichlet rows zero), each ``(nblk, nb, b, b)`` on
        the model's device and zero outside the plan's matvec pattern.
        ``bsb_plan``: the ``(plan, fill plan)`` to fill, built for this mesh
        on this device, such as the transient solid's ``bsb_plan()``; by
        default this model's own."""
        R = self._residual
        topo = R.topology
        cells = topo.cells
        nld = cells.shape[1] * self.dim
        plan, fill = self.bsb_plan() if bsb_plan is None else bsb_plan
        if plan.ndof != self.ndof:
            raise ValueError(f"assem_banded_state_blocks: a plan of {plan.ndof} dofs"
                             f" for a model of {self.ndof}")
        fields = self._fields()
        X = self._coords(fields)
        u, v, vt = fields["state/u1"], fields["state/v1"], fields["state/a1"]
        cell_elem, facet_elem = R.cell_elem_fn(), R.facet_elem_fn()
        has_contact = self._has_contact

        def with_state(local, u_e, v_e, vt_e):
            return {**local, "state/u1": u_e, "state/v1": v_e, "state/a1": vt_e}

        def cell_fn(u_e, v_e, vt_e, Xe, local):
            return cell_elem(Xe, with_state(local, u_e, v_e, vt_e))

        local_c, axes_c = R.gather_cell_locals(fields)
        Jc = vmap(jacfwd(cell_fn, argnums=(0, 1, 2)), in_dims=(0, 0, 0, 0, axes_c))(
            u[cells], v[cells], vt[cells], X[cells], local_c)
        Jc = [J.reshape(-1, nld, nld) for J in Jc]
        Jf = [None] * 3
        if R.has_facet_pass():
            def facet_fn(u_e, v_e, vt_e, Xe, sel, opp_sel, local):
                loc = with_state(local, u_e, v_e, vt_e)
                if has_contact:
                    loc["control/tcontact"] = _contact_traction(
                        u_e, Xe, loc["prop/ncontact"], loc["prop/ycontact"],
                        loc["prop/kcontact"])
                return facet_elem(Xe, sel, opp_sel, loc)

            local_f, axes_f = R.gather_facet_locals(fields)
            cv = cells[topo.facet_cells]
            Jf = vmap(jacfwd(facet_fn, argnums=(0, 1, 2)),
                      in_dims=(0, 0, 0, 0, 0, 0, axes_f))(
                u[cv], v[cv], vt[cv], X[cv], topo.facet_sel, topo.facet_opp_sel, local_f)
            Jf = [J.reshape(-1, nld, nld) for J in Jf]
        K = bsb.bsb_fill(plan, fill, [Jc[0], Jf[0]])
        D = bsb.bsb_fill(plan, fill, [Jc[1], Jf[1]], identity=False)
        M = bsb.bsb_fill(plan, fill, [Jc[2], Jf[2]], identity=False)
        return plan, K, D, M

    def assem_dresu_dp1_cols(self, col_verts) -> torch.Tensor:
        """The ``(ndof, len(col_verts))`` columns of ``dFu/d(control p)`` at
        the given surface vertices, the only ones the FSI coupling needs,
        by facet-level ``jacfwd`` (the whole ``ndof x nvert`` block is too
        large at a large mesh); Dirichlet rows zero."""
        R = self._residual
        ncols = len(col_verts)
        if not R.has_facet_pass() or not self._has_p1:
            return torch.zeros((self.ndof, ncols), dtype=self.dtype, device=self.device)
        topo = R.topology
        fields = self._fields()
        X = self._coords(fields)
        facet_elem = R.facet_elem_fn()
        local_f, axes_f = R.gather_facet_locals(fields)
        cv = topo.cells[topo.facet_cells]

        def facet_fn_p(p_e, u_e, Xe, sel, opp_sel, local):
            loc = {**local, "state/u1": u_e, "control/p1": p_e}
            return facet_elem(Xe, sel, opp_sel, loc)

        Jp = vmap(jacfwd(facet_fn_p), in_dims=(0, 0, 0, 0, 0, axes_f))(
            fields["control/p1"][cv], fields["state/u1"][cv], X[cv],
            topo.facet_sel, topo.facet_opp_sel, local_f)  # (nf, nv, dim, nv)
        dev = self.device
        colmap = torch.full((self.nvert,), ncols, dtype=torch.int64, device=dev)
        colmap[torch.as_tensor(np.asarray(col_verts), device=dev)] = torch.arange(
            ncols, device=dev)
        rows = (cv[:, :, None, None] * self.dim
                + torch.arange(self.dim, device=dev)[None, None, :, None])
        cols = colmap[cv][:, None, None, :]
        C = torch.zeros((self.ndof, ncols + 1), dtype=self.dtype, device=dev)
        C.index_put_((rows.expand(Jp.shape), cols.expand(Jp.shape)), Jp,
                     accumulate=True)
        C = C[:, :ncols].clone()
        C[torch.as_tensor(R.bc_dofs, device=dev)] = 0.0  # Dirichlet rows
        return C

    def _zeros(self, m: int, n: int) -> torch.Tensor:
        return torch.zeros((m, n), dtype=self.dtype, device=self.device)

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.ndof, dtype=self.dtype, device=self.device)

    def _dprop(self, tangent=None) -> dict:
        out = {}
        for row in ("u", "v"):
            for name in self._prop_keys:
                ncols = self.prop[name].numel()
                out[row, name] = (self._jac("prop/" + name, tangent).reshape(self.ndof, ncols)
                                  if row == "u" else self._zeros(self.ndof, ncols))
        return out


class SolidDynamicalModel(_BaseSolidDynamical, BaseDynamicalModel):
    """The nonlinear solid dynamical system."""

    def assem_res(self) -> dict:
        return {"u": self._resu(), "v": self.state["v"] - self.statet["u"]}

    def assem_dres_dstate(self) -> dict:
        n = self.ndof
        return {("u", "u"): self._jac_u_with_contact(), ("u", "v"): self._jac("state/v1"),
                ("v", "u"): self._zeros(n, n), ("v", "v"): self._eye()}

    def assem_dres_dstatet(self) -> dict:
        n = self.ndof
        return {("u", "u"): self._zeros(n, n), ("u", "v"): self._jac("state/a1"),
                ("v", "u"): -self._eye(), ("v", "v"): self._zeros(n, n)}

    def assem_dres_dcontrol(self) -> dict:
        return {("u", "p"): self._jac("control/p1"),
                ("v", "p"): self._zeros(self.ndof, self.nvert)}

    def assem_dres_dprop(self) -> dict:
        return self._dprop()


class LinearizedSolidDynamicalModel(_BaseSolidDynamical, BaseLinearizedDynamicalModel):
    """The action of the solid's Jacobian: its residual is ``dF/dx . dx +
    dF/dxt . dxt + dF/dg . dg`` (and ``dv - dut``)."""

    def __init__(self, residual: FemResidual):
        super().__init__(residual)
        self.dstate = _zeros_like(self.state)
        self.dstatet = _zeros_like(self.statet)
        self.dcontrol = _zeros_like(self.control)

    def set_dstate(self, dstate):
        _assign(self.dstate, dstate)

    def set_dstatet(self, dstatet):
        _assign(self.dstatet, dstatet)

    def set_dcontrol(self, dcontrol):
        _assign(self.dcontrol, dcontrol)

    def _tangent(self) -> dict:
        return self._tangent_fields(self.dstate, self.dstatet, self.dcontrol)

    def assem_res(self) -> dict:
        R = self._residual
        dres = jvp(lambda f: R.assemble_res(f).reshape(-1), (self._fields(),),
                   (self._tangent(),))[1]
        return {"u": dres, "v": self.dstate["v"] - self.dstatet["u"]}

    def assem_dres_dstate(self) -> dict:
        t = self._tangent()
        n = self.ndof
        return {("u", "u"): self._jac_u_with_contact(tangent=t),
                ("u", "v"): self._jac("state/v1", tangent=t),
                ("v", "u"): self._zeros(n, n), ("v", "v"): self._zeros(n, n)}

    def assem_dres_dstatet(self) -> dict:
        t = self._tangent()
        n = self.ndof
        return {("u", "u"): self._zeros(n, n), ("u", "v"): self._jac("state/a1", tangent=t),
                ("v", "u"): self._zeros(n, n), ("v", "v"): self._zeros(n, n)}

    def assem_dres_dcontrol(self) -> dict:
        return {("u", "p"): self._jac("control/p1", tangent=self._tangent()),
                ("v", "p"): self._zeros(self.ndof, self.nvert)}

    def assem_dres_dprop(self) -> dict:
        return self._dprop(self._tangent())


# -- fluid ----------------------------------------------------------------------


class _BaseFluidDynamical:
    def __init__(self, residual: FunctionalResidual):
        self._residual = residual
        self.device, self.dtype = residual.device, residual.dtype
        state, control, prop = (to_tensors(a, self.device, self.dtype)
                                for a in residual.res_args)
        self.state, self.control, self.prop = state, control, prop
        self.statet = {k: v.clone() for k, v in state.items()}

    @property
    def residual(self) -> FunctionalResidual:
        return self._residual

    def set_state(self, state):
        _assign(self.state, state)

    def set_statet(self, statet):
        _assign(self.statet, statet)

    def set_control(self, control):
        _assign(self.control, control)

    def set_prop(self, prop):
        _assign(self.prop, prop)

    def _args(self):
        return dict(self.state), dict(self.control), dict(self.prop)

    def _res_fn(self, state, control, prop):
        raise NotImplementedError

    def _jac(self, argnum: int, cols) -> dict:
        nested = jacfwd(self._res_fn, argnums=argnum)(*self._args())
        return {(rk, ck): nested[rk][ck] for rk in self.state for ck in cols}

    def assem_res(self) -> dict:
        r = self._res_fn(*self._args())
        return {k: r[k] for k in self.state}

    def assem_dres_dstate(self) -> dict:
        return self._jac(0, self.state)

    def assem_dres_dstatet(self) -> dict:
        return {(rk, ck): torch.zeros((self.state[rk].numel(), self.state[ck].numel()),
                                      dtype=self.dtype, device=self.device)
                for rk in self.state for ck in self.state}

    def assem_dres_dcontrol(self) -> dict:
        return self._jac(1, self.control)

    def assem_dres_dprop(self) -> dict:
        return self._jac(2, self.prop)


class FluidDynamicalModel(_BaseFluidDynamical, BaseDynamicalModel):
    """The quasi-steady fluid as a dynamical system."""

    def _res_fn(self, state, control, prop):
        return self._residual.res(state, control, prop)


class LinearizedFluidDynamicalModel(_BaseFluidDynamical, BaseLinearizedDynamicalModel):
    """The action of the fluid's Jacobian along ``(dstate, dcontrol,
    dprop)``."""

    def __init__(self, residual: FunctionalResidual):
        super().__init__(residual)
        self.dstate = _zeros_like(self.state)
        self.dstatet = _zeros_like(self.statet)
        self.dcontrol = _zeros_like(self.control)
        self.dprop = _zeros_like(self.prop)

    def set_dstate(self, dstate):
        _assign(self.dstate, dstate)

    def set_dstatet(self, dstatet):
        _assign(self.dstatet, dstatet)

    def set_dcontrol(self, dcontrol):
        _assign(self.dcontrol, dcontrol)

    def set_dprop(self, dprop):
        _assign(self.dprop, dprop)

    def _res_fn(self, state, control, prop):
        return jvp(self._residual.res, (state, control, prop),
                   (dict(self.dstate), dict(self.dcontrol), dict(self.dprop)))[1]


# -- coupled FSI ------------------------------------------------------------------


class FSIDynamicalModel(BaseDynamicalModel):
    """The coupled dynamical system: state ``u, v, q, p``; control the
    fluid's without its area; prop the solid's, the fluid's and the
    midline ``ymid``."""

    def __init__(self, solid, fluid, solid_fsi_dofs, fluid_fsi_dofs):
        self.solid, self.fluid = solid, fluid
        self.device, self.dtype = solid.device, solid.dtype
        self.state = {k: v.clone() for d in (solid.state, fluid.state) for k, v in d.items()}
        self.statet = {k: v.clone() for d in (solid.statet, fluid.statet)
                       for k, v in d.items()}
        self.control = {k: v.clone() for k, v in list(fluid.control.items())[1:]}
        self.prop = {k: v.clone() for d in (solid.prop, fluid.prop) for k, v in d.items()}
        self.prop["ymid"] = torch.ones(1, dtype=self.dtype, device=self.device)
        self._n_area = fluid.control["area"].numel()
        self.fsimap = FSIMap(fluid.state["p"].numel(), solid.nvert, fluid_fsi_dofs,
                             solid_fsi_dofs)
        self._solid_dofs = torch.as_tensor(self.fsimap.dofs_solid, device=self.device)
        self._fluid_dofs = torch.as_tensor(self.fsimap.dofs_fluid, device=self.device)
        self._coupling = None
        # seconds by part of the last banded Hopf analysis of this model
        # (misc.hopf.linear_stability_banded)
        self.hopf_seconds = {}

    def _transfer_solid_to_fluid(self):
        solid = self.solid
        X = solid._coords(solid._prop_fields())
        u = solid.state["u"].reshape(solid.nvert, solid.dim)
        self.fluid.control["area"] = area_from_surface(
            X + u, self.prop["ymid"][0], self._n_area, self._solid_dofs, self._fluid_dofs)

    def _transfer_fluid_to_solid(self):
        self.solid.control["p"] = pressure_to_solid(
            self.fluid.state["p"], self.solid.nvert, self._solid_dofs, self._fluid_dofs)

    def set_state(self, state):
        _assign(self.state, state)
        self.solid.set_state({k: self.state[k] for k in ("u", "v")})
        self.fluid.set_state({k: self.state[k] for k in ("q", "p")})
        self._transfer_solid_to_fluid()
        self._transfer_fluid_to_solid()

    def set_statet(self, statet):
        _assign(self.statet, statet)
        self.solid.set_statet({k: self.statet[k] for k in ("u", "v")})
        self.fluid.set_statet({k: self.statet[k] for k in ("q", "p")})

    def set_control(self, control):
        _assign(self.control, control)
        self.fluid.set_control({**self.fluid.control, **self.control})

    def set_prop(self, prop):
        _assign(self.prop, prop)
        self.solid.set_prop({k: self.prop[k] for k in self.solid.prop})
        self.fluid.set_prop({k: self.prop[k] for k in self.fluid.prop})
        self._transfer_solid_to_fluid()

    def assem_res(self) -> dict:
        return {**self.solid.assem_res(), **self.fluid.assem_res()}

    def _coupling_mats(self):
        """``d(fluid area)/d(solid u)`` and ``d(solid p)/d(fluid p)``, dense
        on the device (constant, built on first use)."""
        if self._coupling is None:
            self._coupling = tuple(
                torch.as_tensor(a, dtype=self.dtype, device=self.device)
                for a in (self.fsimap.dfluid_dsolid_u(self.solid.dim),
                          self.fsimap.dsolid_dfluid()))
        return self._coupling

    def _sizes(self):
        return (("u", self.solid.ndof), ("v", self.solid.ndof),
                ("q", self.fluid.state["q"].numel()), ("p", self.fluid.state["p"].numel()))

    def _zeros(self, m: int, n: int) -> torch.Tensor:
        return torch.zeros((m, n), dtype=self.dtype, device=self.device)

    def assem_dres_dstate(self) -> dict:
        solid, fluid = self.solid, self.fluid
        dflarea_dslu, dslp_dflp = self._coupling_mats()
        dsl = solid.assem_dres_dstate()
        dsl_dctrl = solid.assem_dres_dcontrol()
        dfl = fluid.assem_dres_dstate()
        dfl_dctrl = fluid.assem_dres_dcontrol()
        sizes = dict(self._sizes())
        out = {}
        for rk in ("u", "v", "q", "p"):
            for ck in ("u", "v", "q", "p"):
                if rk in ("u", "v") and ck in ("u", "v"):
                    blk = dsl[rk, ck]
                elif rk in ("q", "p") and ck in ("q", "p"):
                    blk = dfl[rk, ck]
                elif rk == "u" and ck == "p":
                    # the solid residual by the fluid state: through p only
                    blk = dsl_dctrl["u", "p"] @ dslp_dflp
                elif rk in ("q", "p") and ck == "u":
                    # the fluid residual by the solid state: through area(u)
                    blk = dfl_dctrl[rk, "area"] @ dflarea_dslu
                else:
                    blk = self._zeros(sizes[rk], sizes[ck])
                out[rk, ck] = blk
        return out

    def assem_dres_dstatet(self) -> dict:
        dsl = self.solid.assem_dres_dstatet()
        dfl = self.fluid.assem_dres_dstatet()
        sizes = dict(self._sizes())
        out = {}
        for rk in ("u", "v", "q", "p"):
            for ck in ("u", "v", "q", "p"):
                solid_r, solid_c = rk in ("u", "v"), ck in ("u", "v")
                out[rk, ck] = (dsl[rk, ck] if solid_r and solid_c else
                               dfl[rk, ck] if not (solid_r or solid_c) else
                               self._zeros(sizes[rk], sizes[ck]))
        return out

    def assem_dres_dcontrol(self) -> dict:
        dfl_dctrl = self.fluid.assem_dres_dcontrol()
        return {(rk, ck): (dfl_dctrl[rk, ck] if rk in ("q", "p")
                           else self._zeros(n, self.control[ck].numel()))
                for rk, n in self._sizes() for ck in self.control}

    def assem_dres_dprop(self) -> dict:
        solid, fluid = self.solid, self.fluid
        dflarea_dslu, _ = self._coupling_mats()
        dsl_dprop = solid.assem_dres_dprop()
        dfl_dprop = fluid.assem_dres_dprop()
        dfl_dctrl = fluid.assem_dres_dcontrol()
        out = {}
        for rk, nrow in self._sizes():
            for pk, val in self.prop.items():
                if rk in ("u", "v") and pk in solid.prop:
                    blk = dsl_dprop[rk, pk]
                elif rk in ("q", "p") and pk in fluid.prop:
                    blk = dfl_dprop[rk, pk]
                elif rk in ("q", "p") and pk == "umesh":
                    # the fluid's area depends on the mesh shape
                    blk = dfl_dctrl[rk, "area"] @ dflarea_dslu
                elif rk in ("q", "p") and pk == "ymid":
                    # area = 2 (ymid - y): d(area)/d(ymid) = 2
                    blk = dfl_dctrl[rk, "area"] @ torch.full(
                        (self._n_area, 1), 2.0, dtype=self.dtype, device=self.device)
                else:
                    blk = self._zeros(nrow, val.numel())
                out[rk, pk] = blk
        return out


class LinearizedFSIDynamicalModel(FSIDynamicalModel, BaseLinearizedDynamicalModel):
    """The action of the coupled Jacobian; the coupling tangents are
    chained into the solid's and the fluid's controls."""

    def __init__(self, solid, fluid, solid_fsi_dofs, fluid_fsi_dofs):
        super().__init__(solid, fluid, solid_fsi_dofs, fluid_fsi_dofs)
        self.dstate = _zeros_like(self.state)
        self.dstatet = _zeros_like(self.statet)
        self.dcontrol = _zeros_like(self.control)

    def set_dstate(self, dstate):
        _assign(self.dstate, dstate)
        self.solid.set_dstate({k: self.dstate[k] for k in ("u", "v")})
        self.fluid.set_dstate({k: self.dstate[k] for k in ("q", "p")})
        dflarea_dslu, dslp_dflp = self._coupling_mats()
        self.fluid.set_dcontrol({**self.fluid.dcontrol,
                                 "area": dflarea_dslu @ self.dstate["u"]})
        self.solid.set_dcontrol({"p": dslp_dflp @ self.dstate["p"]})

    def set_dstatet(self, dstatet):
        _assign(self.dstatet, dstatet)
        self.solid.set_dstatet({k: self.dstatet[k] for k in ("u", "v")})
        self.fluid.set_dstatet({k: self.dstatet[k] for k in ("q", "p")})

    def set_dcontrol(self, dcontrol):
        _assign(self.dcontrol, dcontrol)
        self.fluid.set_dcontrol({**self.fluid.dcontrol, **self.dcontrol})
