"""
Transient (time-step) models: solid, fluid and explicitly coupled FSI.

Counterpart of ``vf_fem_tpu.models.transient`` for the explicit forward
path.  States, controls and properties are dicts of tensors on the model's
device; ``model.state0``/``model.control``/``model.prop`` hold the default
values as dicts of numpy arrays with the JAX models' keys, in the same
order.  Newton runs on the 'u' block only; v1 and a1 follow from the
Newmark relations.

Solver parameters supported on this path: ``linear_solver='dense'``;
``jacobian_update`` ('every_iteration' | 'once_per_step');
``fixed_iterations``/``fixed_tail_residual``/``stagnation_ratio`` and the
tolerances (``solvers.newton``); ``assembly`` ('auto' | 'banded' |
'plain'); ``jacobian_refresh_steps``/``jacobian_refresh_mode``/
``jacobian_full_refresh_windows``/``jacobian_refresh_iters``
(``forward.integrate_pure``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..equations import newmark
from ..fem import assembly
from ..residuals.base import FemResidual, FunctionalResidual
from ..solverconst import DEFAULT_NEWTON_SOLVER_PRM
from ..solvers import linalg
from ..solvers.newton import newton_solve

_SUPPORTED = {
    "linear_solver": ("dense",),
    "initial_guess": ("predictor",),
    "jacobian_refresh_mode": ("full", "ns"),
    "jacobian_update": ("every_iteration", "once_per_step"),
    "assembly": ("auto", "banded", "plain"),
}


def solver_params(params) -> dict:
    """Merge ``params`` over the defaults; raise on options this port does
    not implement (so that no run silently takes another path)."""
    p = {**DEFAULT_NEWTON_SOLVER_PRM, **dict(params or {})}
    for key, allowed in _SUPPORTED.items():
        if key in p and p[key] not in allowed:
            raise NotImplementedError(
                f"{key}={p[key]!r} is not ported (supported: {allowed})"
            )
    if p.get("jacobian_refresh_precision") is not None:
        raise NotImplementedError("jacobian_refresh_precision is not ported")
    return p


def _contact_traction(u1, X, n, y, k):
    """Cubic-penalty contact traction at the nodes (..., nv, dim)."""
    gap = (X + u1) @ n - y
    return -(k * torch.clamp(gap, min=0.0) ** 3)[..., None] * n


class SolidModel:
    """Transient solid with Newmark time discretization and nodal penalty
    contact."""

    def __init__(self, residual: FemResidual):
        self._residual = residual
        R = residual
        mesh = R.mesh()
        self.device, self.dtype = R.device, R.dtype
        self.nvert = mesh.num_vertices
        self.dim = mesh.dim
        self.ndof = self.nvert * self.dim
        spec = R.coefficient_spec
        self._has_contact = "control/tcontact" in spec
        self._has_p1 = "control/p1" in spec

        self.state0 = {k: np.zeros(self.ndof) for k in ("u", "v", "a")}
        self.control = {"p1": np.zeros(self.nvert)}
        defaults = R.default_coefficients()
        self.prop = {
            key.split("/", 1)[1]: defaults[key].reshape(-1).copy()
            for key in spec
            if key.startswith("prop/")
        }

        cells = mesh.cells
        fcells = R.topology.facet_cells.cpu().numpy()
        self._cell_dofs = assembly.cell_dof_array(cells, self.dim)
        self._facet_cell_dofs = assembly.cell_dof_array(cells[fcells], self.dim)
        dofs = [self._cell_dofs]
        if R.has_facet_pass():
            dofs.append(self._facet_cell_dofs)
        self._jac_plan = assembly.dense_jacobian_plan(
            dofs, self.ndof, self.device
        )
        self.bc_dofs = torch.as_tensor(R.bc_dofs, device=self.device)
        bc_mask = np.zeros(self.ndof)
        bc_mask[R.bc_dofs] = 1.0
        self._bc_mask = torch.as_tensor(bc_mask, dtype=self.dtype,
                                        device=self.device)

    @property
    def residual(self) -> FemResidual:
        return self._residual

    # -- fields ----------------------------------------------------------------
    def _prop_fields(self, prop: dict) -> dict:
        """{name: flat tensor} -> {'prop/name': shaped tensor}."""
        out = {}
        for key, sp in self._residual.coefficient_spec.items():
            group, name = key.split("/", 1)
            if group != "prop":
                continue
            arr = prop[name]
            if sp.space == "cg1_vector":
                arr = arr.reshape(self.nvert, self.dim)
            out[key] = arr
        return out

    def coords(self, prop_fields: dict) -> torch.Tensor:
        X = self._residual.X_ref
        if "prop/umesh" in prop_fields:
            X = X + prop_fields["prop/umesh"]
        return X

    def _full_fields(self, u1, v1, a1, control, prop_fields):
        fields = dict(prop_fields)
        fields["state/u1"] = u1
        fields["state/v1"] = v1
        fields["state/a1"] = a1
        if self._has_p1:
            fields["control/p1"] = control["p1"]
        if self._has_contact:
            fields["control/tcontact"] = _contact_traction(
                u1, self.coords(prop_fields),
                prop_fields["prop/ncontact"],
                prop_fields["prop/ycontact"][0],
                prop_fields["prop/kcontact"][0],
            )
        return fields

    def _state0_2d(self, state0):
        shape = (self.nvert, self.dim)
        return tuple(state0[k].reshape(shape) for k in ("u", "v", "a"))

    def use_banded(self, params_d: dict) -> bool:
        """'banded' forces the banded kernels (raises if the mesh is not
        bandwidth-ordered), 'plain' the indexed path, 'auto' (default)
        banded whenever the mesh admits a plan, on any device."""
        mode = params_d.get("assembly", "auto")
        if mode == "banded":
            self._residual.banded_plan()
            return True
        if mode == "plain":
            return False
        return self._residual.banded_ok()

    # -- residual and Jacobian --------------------------------------------------
    def res_u(self, u1_flat, state0, control, prop, dt, banded=False):
        """Newton residual of the 'u' block (v1, a1 substituted); Dirichlet
        rows read ``u1``."""
        u1 = u1_flat.reshape(self.nvert, self.dim)
        u0, v0, a0 = self._state0_2d(state0)
        v1 = newmark.newmark_v(u1, u0, v0, a0, dt)
        a1 = newmark.newmark_a(u1, u0, v0, a0, dt)
        fields = self._full_fields(u1, v1, a1, control,
                                   self._prop_fields(prop))
        res = self._residual.assemble_res(fields, banded=banded).reshape(-1)
        return res * (1.0 - self._bc_mask) + u1_flat * self._bc_mask

    def jac_u_blocks(self, u1_flat, state0, control, prop, dt):
        """Per-element Jacobian blocks (Jc, Jf) of the Newton 'u' residual,
        by ``vmap(jacfwd(element residual))``."""
        R = self._residual
        topo = R.topology
        cells = topo.cells
        nld = cells.shape[1] * self.dim
        u1 = u1_flat.reshape(self.nvert, self.dim)
        u0, v0, a0 = self._state0_2d(state0)
        prop_fields = self._prop_fields(prop)
        X = self.coords(prop_fields)
        fields = self._full_fields(u1, torch.zeros_like(u1),
                                   torch.zeros_like(u1), control, prop_fields)
        cell_elem = R.cell_elem_fn()
        facet_elem = R.facet_elem_fn()
        has_contact = self._has_contact

        def with_state(loc, u1_e, s0_e):
            u0_e, v0_e, a0_e = s0_e
            loc = dict(loc)
            loc["state/u1"] = u1_e
            loc["state/v1"] = newmark.newmark_v(u1_e, u0_e, v0_e, a0_e, dt)
            loc["state/a1"] = newmark.newmark_a(u1_e, u0_e, v0_e, a0_e, dt)
            return loc

        def cell_fn(u1_e, Xe, s0_e, local):
            return cell_elem(Xe, with_state(local, u1_e, s0_e))

        local_c, axes_c = R.gather_cell_locals(fields)
        Jc = vmap(jacfwd(cell_fn), in_dims=(0, 0, 0, axes_c))(
            u1[cells], X[cells], (u0[cells], v0[cells], a0[cells]), local_c
        ).reshape(-1, nld, nld)

        if not R.has_facet_pass():
            return Jc, None

        def facet_fn(u1_e, Xe, sel, opp_sel, s0_e, local):
            loc = with_state(local, u1_e, s0_e)
            if has_contact:
                loc["control/tcontact"] = _contact_traction(
                    u1_e, Xe, loc["prop/ncontact"], loc["prop/ycontact"],
                    loc["prop/kcontact"],
                )
            return facet_elem(Xe, sel, opp_sel, loc)

        local_f, axes_f = R.gather_facet_locals(fields)
        cv = cells[topo.facet_cells]
        Jf = vmap(jacfwd(facet_fn), in_dims=(0, 0, 0, 0, 0, axes_f))(
            u1[cv], X[cv], topo.facet_sel, topo.facet_opp_sel,
            (u0[cv], v0[cv], a0[cv]), local_f,
        ).reshape(-1, nld, nld)
        return Jc, Jf

    def jac_u_dense(self, u1_flat, state0, control, prop, dt):
        """Dense Newton Jacobian with identity Dirichlet rows."""
        blocks = [b for b in self.jac_u_blocks(u1_flat, state0, control,
                                               prop, dt) if b is not None]
        A = assembly.scatter_dense_jacobian(self._jac_plan, blocks, self.ndof)
        return assembly.apply_dirichlet_rows(A, self.bc_dofs)

    # -- solves -----------------------------------------------------------------
    def _predictor(self, state0, dt):
        return newmark.newmark_predict_u(state0["u"], state0["v"],
                                         state0["a"], dt)

    def _finish(self, u1, state0, dt):
        u0, v0, a0 = self._state0_2d(state0)
        u1_2d = u1.reshape(self.nvert, self.dim)
        return {
            "u": u1,
            "v": newmark.newmark_v(u1_2d, u0, v0, a0, dt).reshape(-1),
            "a": newmark.newmark_a(u1_2d, u0, v0, a0, dt).reshape(-1),
        }

    def solve_state1_pure(self, state0, control, prop, dt, params=None):
        """One time step from the Newmark predictor, with the Jacobian
        re-assembled every iteration (default) or once per step."""
        params_d = solver_params(params)
        banded = self.use_banded(params_d)
        u_guess = self._predictor(state0, dt)

        def assem(u1):
            return self.res_u(u1, state0, control, prop, dt, banded)

        if params_d.get("jacobian_update", "every_iteration") == "once_per_step":
            factors = linalg.dense_factor(
                self.jac_u_dense(u_guess, state0, control, prop, dt)
            )

            def solve_jac(u1, r):
                return linalg.dense_factor_solve(factors, r)
        else:

            def solve_jac(u1, r):
                A = self.jac_u_dense(u1, state0, control, prop, dt)
                return linalg.dense_solve(A, r)

        u1, info = newton_solve(u_guess, assem, solve_jac, params_d)
        return self._finish(u1, state0, dt), info

    def factorize(self, state0, control, prop, dt, params=None):
        """Equilibrated explicit inverse of the Jacobian at the predictor."""
        u_lin = self._predictor(state0, dt)
        return linalg.dense_factor(
            self.jac_u_dense(u_lin, state0, control, prop, dt)
        )

    def refresh_factors(self, factors, state0, control, prop, dt,
                        params=None):
        """Newton-Schulz refresh of carried factors toward the Jacobian at
        the current predictor."""
        params_d = solver_params(params)
        u_lin = self._predictor(state0, dt)
        A = self.jac_u_dense(u_lin, state0, control, prop, dt)
        iters = int(params_d.get("jacobian_refresh_iters", 2))
        return linalg.dense_refresh(factors, A, iters)

    def solve_state1_stale(self, factors, state0, control, prop, dt,
                           params=None):
        """One time step with carried (stale) Jacobian factors."""
        params_d = solver_params(params)
        banded = self.use_banded(params_d)
        u_guess = self._predictor(state0, dt)

        def assem(u1):
            return self.res_u(u1, state0, control, prop, dt, banded)

        def solve_jac(u1, r):
            return linalg.dense_factor_solve(factors, r)

        u1, info = newton_solve(u_guess, assem, solve_jac, params_d)
        return self._finish(u1, state0, dt), info


class FluidModel:
    """Quasi-steady fluid wrapping a :class:`FunctionalResidual`."""

    def __init__(self, residual: FunctionalResidual):
        self._residual = residual
        state, control, prop = residual.res_args
        self.state0 = {k: np.array(v, dtype=float) for k, v in state.items()}
        self.control = {k: np.array(v, dtype=float) for k, v in control.items()}
        self.prop = {k: np.array(v, dtype=float) for k, v in prop.items()}

    def solve_pure(self, control, prop, state_proto):
        """Quasi-steady solve: state1 = state - res(state, g, p), which does
        not depend on ``state``."""
        zero = {k: torch.zeros_like(v) for k, v in state_proto.items()}
        r = self._residual.res(zero, control, prop)
        return {k: zero[k] - r[k] for k in zero}


class ExplicitFSIModel:
    """Staggered explicit coupling: the solid sees the previous step's
    fluid pressure; the fluid sees the current step's solid geometry.

    State ``{u, v, a, q, p}``; control ``{psub, psup}``; props = solid props
    + fluid props + the coupling midline ``ymid``."""

    def __init__(self, solid: SolidModel, fluid: FluidModel,
                 solid_fsi_dofs: np.ndarray, fluid_fsi_dofs: np.ndarray):
        self.solid = solid
        self.fluid = fluid
        self.device, self.dtype = solid.device, solid.dtype
        self.state0 = {
            **{k: v.copy() for k, v in solid.state0.items()},
            **{k: v.copy() for k, v in fluid.state0.items()},
        }
        fl_keys = list(fluid.control)
        self._control_keys = fl_keys[1:]  # fluid control minus 'area'
        self.control = {k: fluid.control[k].copy() for k in self._control_keys}
        self.prop = {
            **{k: v.copy() for k, v in solid.prop.items()},
            **{k: v.copy() for k, v in fluid.prop.items()},
            "ymid": np.array([1.0]),
        }
        self._solid_prop_keys = list(solid.prop)
        self._fluid_prop_keys = list(fluid.prop)
        self._n_area = fluid.control["area"].size
        self._solid_dofs = torch.as_tensor(
            np.asarray(solid_fsi_dofs, dtype=np.int64), device=self.device
        )
        self._fluid_dofs = torch.as_tensor(
            np.asarray(fluid_fsi_dofs, dtype=np.int64), device=self.device
        )

    # -- coupling maps ----------------------------------------------------------
    def _pressure_to_solid(self, p_fluid: torch.Tensor) -> torch.Tensor:
        out = p_fluid.new_zeros((self.solid.nvert,))
        out[self._solid_dofs] = p_fluid[self._fluid_dofs]
        return out

    def _area_from_u1(self, u1_flat: torch.Tensor, prop: dict) -> torch.Tensor:
        """fluid area = 2*(ymid - y_surface)."""
        u1 = u1_flat.reshape(self.solid.nvert, self.solid.dim)
        sl_prop, _ = self._split_prop(prop)
        X = self.solid.coords(self.solid._prop_fields(sl_prop))
        solid_area = 2.0 * (prop["ymid"][0] - (X + u1)[:, 1])
        area = solid_area.new_zeros((self._n_area,))
        area[self._fluid_dofs] = solid_area[self._solid_dofs]
        return area

    def _split_prop(self, prop: dict):
        sl = {k: prop[k] for k in self._solid_prop_keys}
        fl = {k: prop[k] for k in self._fluid_prop_keys}
        return sl, fl

    def _solid_inputs(self, state0, prop):
        sl_prop, _ = self._split_prop(prop)
        p_solid = self._pressure_to_solid(state0["p"])
        sl_state0 = {k: state0[k] for k in ("u", "v", "a")}
        return sl_state0, {"p1": p_solid}, sl_prop

    def _fluid_step(self, uva1, state0, control, prop):
        _, fl_prop = self._split_prop(prop)
        area = self._area_from_u1(uva1["u"], prop)
        fl_control = {"area": area, **{k: control[k] for k in control}}
        qp1 = self.fluid.solve_pure(
            fl_control, fl_prop, {"q": state0["q"], "p": state0["p"]}
        )
        return {**uva1, **qp1}

    # -- pure step functions ------------------------------------------------------
    def step_pure(self, state0, control, prop, dt, params=None):
        """One coupled step, re-assembling the Jacobian in each solve."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_pure(
            sl_state0, sl_control, sl_prop, dt, params
        )
        return self._fluid_step(uva1, state0, control, prop), info

    def factorize(self, state0, control, prop, dt, params=None):
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        return self.solid.factorize(sl_state0, sl_control, sl_prop, dt, params)

    def refresh_factors(self, factors, state0, control, prop, dt, params=None):
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        return self.solid.refresh_factors(
            factors, sl_state0, sl_control, sl_prop, dt, params
        )

    def step_pure_stale(self, factors, state0, control, prop, dt,
                        params=None):
        """One coupled step with carried Jacobian factors."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_stale(
            factors, sl_state0, sl_control, sl_prop, dt, params
        )
        return self._fluid_step(uva1, state0, control, prop), info
