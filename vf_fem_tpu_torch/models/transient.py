"""
Transient (time-step) models: solid, fluid and explicitly coupled FSI.

Counterpart of ``vf_fem_tpu.models.transient`` for the explicit forward
path.  States, controls and properties are dicts of tensors on the model's
device; ``model.state0``/``model.control``/``model.prop`` hold the default
values as dicts of numpy arrays with the JAX models' keys, in the same
order.  Newton runs on the 'u' block only; v1 and a1 follow from the
Newmark relations.

Solver parameters supported on this path: ``linear_solver`` ('dense' |
'cg' | 'bsb' | 'btd'), with ``krylov`` ('bicgstab' | 'pcg'),
``krylov_tolerance`` and ``krylov_max_iter`` for the two matrix-free ones
and ``btd_store_dtype`` (None | 'bfloat16') for the block-Thomas direct
one; ``jacobian_update`` ('every_iteration' | 'once_per_step');
``fixed_iterations``/``fixed_tail_residual``/``stagnation_ratio`` and the
tolerances (``solvers.newton``); ``assembly`` ('auto' | 'banded' |
'plain'); ``jacobian_refresh_steps``/``jacobian_refresh_mode``/
``jacobian_full_refresh_windows``/``jacobian_refresh_iters``
(``forward.integrate_pure``).  ``btd_offdiag_dtype`` and
``btd_factor_dtype`` raise unless None.

The gradient path (``adjoint``): :meth:`SolidModel.solve_state1_diff`
solves a step's u1 inside a ``torch.autograd.Function`` whose backward is
the implicit-function-theorem rule of the JAX package's ``solve_u1`` /
``solve_u1_stale`` custom VJPs (:class:`_SolveU1`): ``J(u1)^T lam = u1_bar``, then
``theta_bar = -(dR/dtheta)^T lam`` for the state, control, properties and
the step's coefficient row, on one residual graph rebuilt at u1.  Options:
``adjoint_refine`` ('stale', the default: Richardson refinement with the
window's carried factors, ``adjoint_refine_tol``/``adjoint_refine_iters``,
stopped on ``stagnation_ratio``; 'exact': full-precision factors rebuilt
at u1 and one transposed solve).  'dense' and 'btd' have transposed
solves; 'cg' and 'bsb' raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import ops
from ..equations import newmark
from ..fem import assembly
from ..residuals.base import FemResidual, FunctionalResidual
from ..solverconst import DEFAULT_NEWTON_SOLVER_PRM
from ..solvers import bsb, btd, linalg
from ..solvers.newton import SolveInfo, newton_solve

# solvers whose factors are built from the element Jacobian blocks, once
# per step by default: the matrix-free Newton-Krylov 'cg' (element-by-
# element operator) and 'bsb' (block-banded), both with nodal block-Jacobi,
# and the block-Thomas direct 'btd' on the block-banded Jacobian
ELEMENT_SOLVERS = ("cg", "bsb", "btd")

_SUPPORTED = {
    "linear_solver": ("dense",) + ELEMENT_SOLVERS,
    "btd_store_dtype": (None,) + tuple(btd.STORE_DTYPES),
    "btd_offdiag_dtype": (None,),
    "btd_factor_dtype": (None,),
    "krylov": ("bicgstab", "pcg"),
    "initial_guess": ("predictor",),
    "jacobian_refresh_mode": ("full", "ns"),
    "jacobian_update": ("every_iteration", "once_per_step"),
    "assembly": ("auto", "banded", "plain"),
    "adjoint_refine": ("stale", "exact"),
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


def _element_solver(params_d: dict) -> bool:
    return params_d.get("linear_solver", "dense") in ELEMENT_SOLVERS


class StepCoefs:
    """The Newmark coefficients of one step as tensors, where a step's
    ``dt`` is not a Python float: ``row``, the (8,) row of
    ``equations.newmark.coefficients`` (computed in float64) in the model's
    dtype on the device, which K5 reads (``ops.newmark_row``), and ``k``,
    its entries as 0-d tensors, which the residual multiplies by (the same
    bits as the Python floats).  A CUDA graph of the step reads each
    replay's row (``step_graph``).  Two records are the same step only if
    they are the same object."""

    __slots__ = ("row", "k")

    def __init__(self, row: torch.Tensor, dtype):
        self.row = row.to(dtype)
        self.k = tuple(self.row.unbind(0))


def newmark_coefs(dt):
    """The step's Newmark coefficients: ``dt.k`` of a :class:`StepCoefs`,
    else the Python floats of ``dt``."""
    return dt.k if isinstance(dt, StepCoefs) else newmark.coefficients(dt)


class KrylovFactors(NamedTuple):
    """Frozen Jacobian of a matrix-free solve: the EBE operator ('cg') or
    the block-banded array ('bsb'), and the nodal block-Jacobi inverse."""

    A: object
    Dinv: torch.Tensor


def _versions(tensors):
    """The version counters of ``tensors``, or None where one is an
    inference tensor (which keeps none)."""
    if any(t.is_inference() for t in tensors):
        return None
    return tuple(t._version for t in tensors)


def _flatten(state0: dict, control: dict, prop: dict):
    """A step's inputs as ``(layout, tensors)`` for an autograd.Function:
    the key lists of the three dicts and their tensors in that order."""
    layout = (tuple(state0), tuple(control), tuple(prop))
    return layout, (*state0.values(), *control.values(), *prop.values())


def _unflatten(layout, tensors):
    """The inverse of :func:`_flatten`."""
    out, i = [], 0
    for keys in layout:
        out.append(dict(zip(keys, tensors[i:i + len(keys)])))
        i += len(keys)
    return tuple(out)


class _SolveU1(torch.autograd.Function):
    """u1 of one step by Newton, with a refresh window's carried
    ``factors`` or (None) factors built in the step; no graph is recorded.
    Backward: the IFT rule (``SolidModel._ift_backward``).  The guess gets
    no cotangent, nor do the factors: they were built without a graph from
    detached inputs, and the root does not depend on them."""

    @staticmethod
    def forward(solid, params_d, dt, layout, factors, guess, row, *flat):
        state0, control, prop = _unflatten(layout, flat)
        u1, info = solid._newton(guess, state0, control, prop, dt, params_d,
                                 factors)
        # a Newton run that takes no iteration returns its guess, an input
        return (u1.clone() if u1 is guess else u1, *info)

    @staticmethod
    def setup_context(ctx, inputs, output):
        solid, params_d, dt, layout, factors, guess, row, *flat = inputs
        ctx.solid, ctx.params_d, ctx.dt, ctx.layout = solid, params_d, dt, layout
        ctx.factors = factors  # a reference to the window's factors, not a copy
        ctx.save_for_backward(output[0], row, *flat)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, u1_bar, *_):
        return (None,) * 6 + ctx.solid._ift_backward(ctx, u1_bar,
                                                     ctx.needs_input_grad[6:])


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

        # element vertex arrays: the cells, then the facets' cells when the
        # residual has a facet pass (the order of the Jacobian blocks)
        cells = mesh.cells
        fcells = R.topology.facet_cells.cpu().numpy()
        self._elem_cells = [cells]
        if R.has_facet_pass():
            self._elem_cells.append(cells[fcells])
        self._elem_dofs = [assembly.cell_dof_array(c, self.dim)
                           for c in self._elem_cells]
        # static plans, built on first use: a Krylov model never builds the
        # dense Jacobian's plan, nor a dense one the Krylov plans
        self._jac_plan = None
        self._ebe = None
        self._bsb = None
        # Krylov solves and iterations since the last reset (read on the
        # host by the stopping rule anyway)
        self.krylov_counts = {"solves": 0, "iterations": 0}
        # K5's state and the predictor it wrote (``_finish``), and how many
        # predictors were taken from it or formed (``_predictor``)
        self._carry = None
        self.predictor_counts = {"carried": 0, "formed": 0}
        # the gradient path's adjoint solves and their refinement iterations
        self.adjoint_counts = {"solves": 0, "refine_iterations": 0}
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
        rows read ``u1``.  ``dt`` is a float or a :class:`StepCoefs`."""
        u1 = u1_flat.reshape(self.nvert, self.dim)
        u0, v0, a0 = self._state0_2d(state0)
        k = newmark_coefs(dt)
        v1 = newmark.velocity_k(u1, u0, v0, a0, k)
        a1 = newmark.acceleration_k(u1, u0, v0, a0, k)
        fields = self._full_fields(u1, v1, a1, control,
                                   self._prop_fields(prop))
        res = self._residual.assemble_res(fields, banded=banded).reshape(-1)
        return res * (1.0 - self._bc_mask) + u1_flat * self._bc_mask

    def res_pure(self, state1, state0, control, prop, dt):
        """The step residual of every block at ``state1``: the Newton 'u'
        residual, and the Newmark identities of 'v' and 'a'."""
        u1 = state1["u"].reshape(self.nvert, self.dim)
        u0, v0, a0 = self._state0_2d(state0)
        k = newmark_coefs(dt)
        return {
            "u": self.res_u(state1["u"], state0, control, prop, dt),
            "v": state1["v"] - newmark.velocity_k(u1, u0, v0, a0, k).reshape(-1),
            "a": state1["a"] - newmark.acceleration_k(u1, u0, v0, a0, k).reshape(-1),
        }

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
        if self._jac_plan is None:
            self._jac_plan = assembly.dense_jacobian_plan(
                self._elem_dofs, self.ndof, self.device
            )
        A = assembly.scatter_dense_jacobian(self._jac_plan, blocks, self.ndof)
        return assembly.apply_dirichlet_rows(A, self.bc_dofs)

    # -- matrix-free (Krylov) Jacobians -------------------------------------------
    def jac_u_ebe(self, u1_flat, state0, control, prop, dt):
        """Element-by-element operator of the Newton Jacobian."""
        if self._ebe is None:
            dofs = [torch.as_tensor(d, device=self.device)
                    for d in self._elem_dofs]
            plans = assembly.ebe_plans(self._elem_cells, self.nvert, self.dim,
                                       self.device)
            self._ebe = (dofs, plans)
        dofs, plans = self._ebe
        Jc, Jf = self.jac_u_blocks(u1_flat, state0, control, prop, dt)
        return assembly.EBEOperator(
            J_cells=Jc.contiguous(), cell_dofs=dofs[0],
            J_facets=None if Jf is None else Jf.contiguous(),
            facet_dofs=None if Jf is None else dofs[1],
            bc_dofs=self.bc_dofs, plans=plans,
        )

    def bsb_plan(self):
        """(BSBPlan, its fill plan on the device), built on first use;
        raises ``ValueError`` unless the mesh is bandwidth-ordered."""
        if self._bsb is None:
            plan = bsb.plan_bsb(self._elem_dofs, self.ndof, self._residual.bc_dofs)
            self._bsb = (plan, bsb.fill_plan(plan, self.device))
        return self._bsb

    def make_iter_factors(self, u_lin, state0, control, prop, dt, params_d):
        """Frozen factors at ``u_lin`` from the element Jacobian blocks:
        the block-Thomas factors of the block-banded Jacobian ('btd'), or
        the Krylov operator with its block-Jacobi inverse ('cg' | 'bsb')."""
        op = self.jac_u_ebe(u_lin, state0, control, prop, dt)
        ls = params_d.get("linear_solver")
        if ls in ("bsb", "btd"):
            plan, fill = self.bsb_plan()
            blocks = bsb.bsb_fill(plan, fill, [op.J_cells, op.J_facets])
            if ls == "btd":
                return btd.btd_factor(
                    plan, blocks, store_dtype=params_d.get("btd_store_dtype")
                )
            return KrylovFactors(blocks, op.block_diag_inverse(self.dim))
        return KrylovFactors(op, op.block_diag_inverse(self.dim))

    def iter_solve(self, factors, r, params_d):
        """Solve with frozen Krylov factors: block-Jacobi BiCGStab (default;
        the Jacobian is nonsymmetric through the follower-pressure terms)
        or PCG (``krylov='pcg'``)."""
        A, Dinv = factors
        if params_d.get("linear_solver") == "bsb":
            plan, fill = self.bsb_plan()

            def matvec(v):
                return ops.bsb_matvec(plan, A, v, fill.pattern)
        else:
            matvec = A.matvec
        solver = (linalg.pcg if params_d.get("krylov", "bicgstab") == "pcg"
                  else linalg.bicgstab)
        result = solver(
            matvec, r, precond=lambda v: assembly.block_jacobi_apply(Dinv, v),
            tol=params_d.get("krylov_tolerance", 1e-8),
            max_iter=params_d.get("krylov_max_iter", 1000),
        )
        self.krylov_counts["solves"] += 1
        self.krylov_counts["iterations"] += result.n_iter
        return result.x

    # -- solves -----------------------------------------------------------------
    def _predictor(self, state0, dt):
        """The Newmark predictor of ``state0`` over ``dt``: the one K5 wrote
        with the state when ``state0`` holds that state's very tensors,
        unmodified (same version counters), and ``dt`` is the step it was
        formed for (for a :class:`StepCoefs`, that very record); else
        formed here, which a step of coefficient rows cannot do (its row
        holds the next step's predictor coefficients) and raises."""
        carry = self._carry
        fields = tuple(state0[k] for k in ("u", "v", "a"))
        if (carry is not None and carry[2] == dt
                and all(a is b for a, b in zip(fields, carry[0]))
                and _versions(fields + (carry[3],)) == carry[1]):
            self.predictor_counts["carried"] += 1
            return carry[3]
        if isinstance(dt, StepCoefs):
            raise RuntimeError("a step of coefficient rows takes its predictor"
                               " from carry_predictor")
        self.predictor_counts["formed"] += 1
        return newmark.newmark_predict_u(*fields, dt)

    def carry_predictor(self, fields, u_next, dt):
        """Keep ``u_next`` as the predictor over ``dt`` (a float or a
        :class:`StepCoefs`) of the state of tensors ``fields`` (u, v, a) as
        they are now: what :meth:`_finish` keeps for the state it returns,
        for a state held in buffers of the caller's (``forward``)."""
        versions = _versions(tuple(fields) + (u_next,))
        self._carry = (None if versions is None else
                       (tuple(fields), versions, dt, u_next))

    def carried_predictor(self):
        """The predictor the last step wrote with its state (None before
        any step)."""
        return None if self._carry is None else self._carry[3]

    def _finish(self, u1, state0, dt, dt_next=None):
        """The step's state: v1, a1 by the fused Newmark update (kernel K5
        on CUDA tensors), which also writes the predictor of the next step
        (of ``dt_next``, by default ``dt``; a :class:`StepCoefs` ``dt``
        carries its own); it is kept for :meth:`_predictor` with the
        state's tensors and their versions."""
        u0, v0, a0 = state0["u"], state0["v"], state0["a"]
        if isinstance(dt, StepCoefs):
            v1, a1, u_next = ops.newmark_update_coefs(u1, u0, v0, a0, dt.row)
        else:
            v1, a1, u_next = ops.newmark_update(u1, u0, v0, a0, dt,
                                                dt_next=dt_next)
        self.carry_predictor((u1, v1, a1), u_next,
                             dt if dt_next is None else dt_next)
        return {"u": u1, "v": v1, "a": a1}

    def solve_state1_pure(self, state0, control, prop, dt, params=None,
                          dt_next=None):
        """One time step from the Newmark predictor.  The Jacobian is
        re-assembled every iteration (the dense default) or once per step
        (the default of the element-block solvers 'cg', 'bsb', 'btd').
        ``dt_next``, the next step's dt where known, is the step of the
        predictor K5 writes with the state."""
        params_d = solver_params(params)
        u_guess = self._predictor(state0, dt)
        u1, info = self._newton(u_guess, state0, control, prop, dt, params_d)
        return self._finish(u1, state0, dt, dt_next), info

    def _newton(self, u_guess, state0, control, prop, dt, params_d,
                factors=None):
        """Newton's u1 of one step from ``u_guess``: with the carried
        ``factors``, or by the Jacobian update of ``params_d``."""
        banded = self.use_banded(params_d)

        def assem(u1):
            return self.res_u(u1, state0, control, prop, dt, banded)

        if factors is not None:

            def solve_jac(u1, r):
                return self.solve_factors(factors, r, params_d)

            return newton_solve(u_guess, assem, solve_jac, params_d)
        element = _element_solver(params_d)
        update = params_d.get("jacobian_update",
                              "once_per_step" if element else "every_iteration")
        if update == "once_per_step":
            factors = self.factorize(state0, control, prop, dt, params_d)

            def solve_jac(u1, r):
                return self.solve_factors(factors, r, params_d)
        elif element:

            def solve_jac(u1, r):
                return self.solve_factors(
                    self.make_iter_factors(u1, state0, control, prop, dt,
                                           params_d),
                    r, params_d,
                )
        else:

            def solve_jac(u1, r):
                A = self.jac_u_dense(u1, state0, control, prop, dt)
                return linalg.dense_solve(A, r)

        return newton_solve(u_guess, assem, solve_jac, params_d)

    def factorize(self, state0, control, prop, dt, params=None):
        """Factors of the Jacobian at the predictor: the block-Thomas
        factors ('btd'), the frozen Krylov factors ('cg' | 'bsb'), or the
        equilibrated explicit inverse."""
        params_d = solver_params(params)
        u_lin = self._predictor(state0, dt)
        if _element_solver(params_d):
            return self.make_iter_factors(u_lin, state0, control, prop, dt,
                                          params_d)
        return linalg.dense_factor(
            self.jac_u_dense(u_lin, state0, control, prop, dt)
        )

    def solve_factors(self, factors, r, params_d):
        """Solve with factors from :meth:`factorize`, by their kind."""
        if isinstance(factors, btd.BTDFactors):
            return btd.btd_solve(self.bsb_plan()[0], factors, r)
        if isinstance(factors, KrylovFactors):
            return self.iter_solve(factors, r, params_d)
        return linalg.dense_factor_solve(factors, r)

    def refresh_factors(self, factors, state0, control, prop, dt,
                        params=None):
        """Newton-Schulz refresh of carried factors toward the Jacobian at
        the current predictor; the block-Thomas and Krylov factors are
        rebuilt from the element Jacobian blocks."""
        params_d = solver_params(params)
        if isinstance(factors, (btd.BTDFactors, KrylovFactors)):
            return self.factorize(state0, control, prop, dt, params_d)
        u_lin = self._predictor(state0, dt)
        A = self.jac_u_dense(u_lin, state0, control, prop, dt)
        iters = int(params_d.get("jacobian_refresh_iters", 2))
        return linalg.dense_refresh(factors, A, iters)

    def solve_state1_stale(self, factors, state0, control, prop, dt,
                           params=None, dt_next=None):
        """One time step with carried (stale) Jacobian factors (``dt_next``
        as in :meth:`solve_state1_pure`)."""
        params_d = solver_params(params)
        u_guess = self._predictor(state0, dt)
        u1, info = self._newton(u_guess, state0, control, prop, dt, params_d,
                                factors)
        return self._finish(u1, state0, dt, dt_next), info

    # -- the gradient path ---------------------------------------------------------
    def solve_state1_diff(self, state0, control, prop, dt, row, params=None,
                          factors=None):
        """One time step as a differentiable function of ``state0``,
        ``control``, ``prop`` and the step's coefficient row ``row`` (a row
        of ``equations.newmark.coefficient_rows`` in the model's dtype,
        whose values are those of the float ``dt`` and the next step's):
        u1 by :class:`_SolveU1` (with a window's ``factors`` where given)
        from the Newmark predictor of the detached state, then
        v1, a1 by K5 under ``ops.newmark_step`` (K5T backward).  The values
        are :meth:`solve_state1_pure`'s / :meth:`solve_state1_stale`'s bit
        for bit; nothing is carried between steps."""
        params_d = solver_params(params)
        u0, v0, a0 = (state0[k] for k in ("u", "v", "a"))
        guess = newmark.newmark_predict_u(u0.detach(), v0.detach(),
                                          a0.detach(), dt)
        layout, flat = _flatten(state0, control, prop)
        out = _SolveU1.apply(self, params_d, dt, layout, factors, guess, row,
                             *flat)
        u1 = out[0]
        v1, a1, _ = ops.newmark_step(u1, u0, v0, a0, row)
        return {"u": u1, "v": v1, "a": a1}, SolveInfo(*out[1:])

    def _ift_backward(self, ctx, u1_bar, needs):
        """The IFT rule of one step: with ``J = dR/du1`` at the saved u1,
        solve ``J^T lam = u1_bar`` (:meth:`_adjoint_solve`) and return
        ``-(dR/dtheta)^T lam`` for the row and each flat input that
        ``needs`` a gradient (None for the others).  Every ``J^T v`` and
        the final product are reverse passes over one residual graph
        rebuilt at u1, so the banded kernels K1 and K2 run through each
        other's backward."""
        u1, row, *flat = ctx.saved_tensors
        params_d, layout = ctx.params_d, ctx.layout
        if u1_bar is None or not any(needs):
            return (None,) * len(needs)
        ls = params_d.get("linear_solver", "dense")
        if ls in ("cg", "bsb"):
            op = ("EBEOperator.matvec_transpose" if ls == "cg"
                  else "bsb_matvec_t (vf_fem_tpu/solvers/bsb.py:168)")
            raise NotImplementedError(
                f"the adjoint of linear_solver={ls!r} needs {op}, which is not"
                " ported; use 'dense' or 'btd'")
        banded = self.use_banded(params_d)
        # only the residual is recorded: the solves below run without a
        # graph (grad mode is off in backward), or factors built at u1
        # would keep one alive
        with torch.enable_grad():
            u = u1.detach().requires_grad_()
            leaves = [t.detach().requires_grad_(bool(w))
                      for t, w in zip((row, *flat), needs)]
            state0, control, prop = _unflatten(layout, leaves[1:])
            r = self.res_u(u, state0, control, prop,
                           StepCoefs(leaves[0], self.dtype), banded)

        def JT(v):
            return torch.autograd.grad(r, u, v, retain_graph=True)[0]

        detached = _unflatten(layout, [t.detach() for t in flat])
        lam = self._adjoint_solve(JT, u1.detach(), detached, ctx.dt, params_d,
                                  ctx.factors, u1_bar.contiguous())
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(r, wanted, -lam, allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)

    def _adjoint_solve(self, JT, u1, inputs, dt, params_d, factors, u1_bar):
        """``lam`` with ``J(u1)^T lam = u1_bar``: refined with the carried
        ``factors`` (``adjoint_refine='stale'``, the default where there
        are factors), else one transposed solve with full-precision factors
        built at u1 (the JAX package's 'exact' mode and its rule for a
        step that factors itself)."""
        self.adjoint_counts["solves"] += 1
        if factors is not None and params_d.get("adjoint_refine", "stale") == "stale":
            return self._refined_adjoint(JT, factors, u1_bar, params_d)
        state0, control, prop = inputs
        if params_d.get("linear_solver", "dense") == "btd":
            exact = {k: v for k, v in params_d.items() if k != "btd_store_dtype"}
            fac = self.make_iter_factors(u1, state0, control, prop, dt, exact)
            return btd.btd_solve_t(self.bsb_plan()[0], fac, u1_bar)
        A = self.jac_u_dense(u1, state0, control, prop, dt)
        return linalg.dense_solve_transpose(A, u1_bar)

    def solve_factors_t(self, factors, r):
        """Carried factors applied as a transposed preconditioner,
        ``M^-T r`` (block-Thomas factors or the dense inverse)."""
        if isinstance(factors, btd.BTDFactors):
            return btd.btd_solve_t(self.bsb_plan()[0], factors, r)
        return linalg.dense_factor_solve_t(factors, r)

    def _refined_adjoint(self, JT, factors, u1_bar, params_d):
        """Richardson iteration ``lam += M^-T (u1_bar - J^T lam)`` with the
        carried factors as ``M`` (``refined_adjoint_solve`` of the JAX
        package): it keeps the lowest-residual iterate and stops below
        ``adjoint_refine_tol`` relative to ``|u1_bar|``, when an iteration
        fails to reduce the residual by ``stagnation_ratio``, or after
        ``adjoint_refine_iters`` iterations.  Each test reads the norm on
        the host."""
        tol = params_d.get("adjoint_refine_tol", 1e-8)
        max_it = int(params_d.get("adjoint_refine_iters", 25))
        stag = params_d.get("stagnation_ratio", 0.9)
        norm = torch.linalg.vector_norm
        bnorm = float(norm(u1_bar))
        lam = self.solve_factors_t(factors, u1_bar)
        r = u1_bar - JT(lam)
        rn = float(norm(r))
        rn_prev = float("inf")
        lam_best, rn_best, k = lam, rn, 0
        while rn >= tol * bnorm and rn < stag * rn_prev and k < max_it:
            lam = lam + self.solve_factors_t(factors, r)
            r = u1_bar - JT(lam)
            rn_prev, rn = rn, float(norm(r))
            if rn < rn_best:
                lam_best, rn_best = lam, rn
            k += 1
        self.adjoint_counts["refine_iterations"] += k
        return lam_best


class FluidModel:
    """Quasi-steady fluid wrapping a :class:`FunctionalResidual`."""

    def __init__(self, residual: FunctionalResidual):
        self._residual = residual
        state, control, prop = residual.res_args
        self.state0 = {k: np.array(v, dtype=float) for k, v in state.items()}
        self.control = {k: np.array(v, dtype=float) for k, v in control.items()}
        self.prop = {k: np.array(v, dtype=float) for k, v in prop.items()}

    def res_pure(self, state, control, prop):
        """The fluid residual at ``state``."""
        return self._residual.res(state, control, prop)

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

    def res_pure(self, state1, state0, control, prop, dt):
        """The staggered step's residual of every block at ``state1``: the
        solid's under the previous step's pressure, the fluid's on the
        current geometry."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        res = self.solid.res_pure({k: state1[k] for k in ("u", "v", "a")},
                                  sl_state0, sl_control, sl_prop, dt)
        _, fl_prop = self._split_prop(prop)
        area = self._area_from_u1(state1["u"], prop)
        fl_control = {"area": area, **{k: control[k] for k in control}}
        res.update(self.fluid.res_pure({"q": state1["q"], "p": state1["p"]},
                                       fl_control, fl_prop))
        return res

    # -- pure step functions ------------------------------------------------------
    def step_pure(self, state0, control, prop, dt, params=None, dt_next=None):
        """One coupled step, re-assembling the Jacobian in each solve;
        ``dt_next``, the next step's dt where known, is the step of the
        predictor written with the state (``SolidModel._finish``)."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_pure(
            sl_state0, sl_control, sl_prop, dt, params, dt_next
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
                        params=None, dt_next=None):
        """One coupled step with carried Jacobian factors (``dt_next`` as in
        :meth:`step_pure`)."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_stale(
            factors, sl_state0, sl_control, sl_prop, dt, params, dt_next
        )
        return self._fluid_step(uva1, state0, control, prop), info

    def step_diff(self, state0, control, prop, dt, row, params=None,
                  factors=None):
        """One coupled step as a differentiable function of the state,
        control, properties and the step's coefficient row (the gradient
        path; ``SolidModel.solve_state1_diff``), with the window's carried
        ``factors`` or factors built in the step; the values are
        :meth:`step_pure`'s / :meth:`step_pure_stale`'s bit for bit."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_diff(
            sl_state0, sl_control, sl_prop, dt, row, params, factors
        )
        return self._fluid_step(uva1, state0, control, prop), info
