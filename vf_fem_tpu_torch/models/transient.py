"""
Transient (time-step) models: solid, fluid and explicitly coupled FSI.

Counterpart of ``vf_fem_tpu.models.transient`` for the explicit forward
path.  States, controls and properties are dicts of tensors on the model's
device; ``model.state0``/``model.control``/``model.prop`` hold the default
values as dicts of numpy arrays with the JAX models' keys, in the same
order.  Newton runs on the 'u' block only; v1 and a1 follow from the
Newmark relations.

Solver parameters supported on this path: ``linear_solver`` ('dense' |
'cg' | 'bsb' | 'btd' | 'spike'), with ``krylov`` ('bicgstab' | 'pcg'),
``krylov_tolerance`` and ``krylov_max_iter`` for the two matrix-free ones,
``btd_store_dtype`` (None | 'bfloat16') for the two block-tridiagonal direct
ones and ``spike_partitions`` (8) for the SPIKE one (``solvers.spike``:
forward solves only, its gradient path raises); ``jacobian_update`` ('every_iteration' | 'once_per_step');
``fixed_iterations``/``fixed_tail_residual``/``stagnation_ratio`` and the
tolerances (``solvers.newton``); ``assembly`` ('auto' | 'banded' |
'plain'); ``jacobian_refresh_steps``/``jacobian_refresh_mode``/
``jacobian_full_refresh_windows``/``jacobian_refresh_iters``/
``jacobian_refresh_precision`` (``forward.integrate_pure``; every
precision the JAX package takes computes IEEE products here: see
``_SUPPORTED``).  ``btd_offdiag_dtype`` and
``btd_factor_dtype`` raise unless None.

A batch of variants (``parallel.sweep``, ``forward.integrate_batch_pure``):
the ``*_batch`` step functions take states, controls and properties with
a leading batch axis and step every variant at once, with the dense
solver only.  What is the same for every variant runs with that explicit
axis: the Newton loop (``solvers.newton.newton_solve(batched=True)``,
whose adaptive stop is one host read a batch iteration), the Newmark
predictor and K5 (one launch over the batch), the refresh windows, and
the IFT rule's adjoint solves and its refinement loop.  The per-variant
algebra runs under ``torch.func.vmap`` of the single-variant methods: the
residual (K1/K2 through their vmap rules: the batch is more channels of
one launch), the element Jacobian, the dense factorization, its
Newton-Schulz refresh and solves, the coupling maps and the fluid step.

The gradient path (``adjoint``): :meth:`SolidModel.solve_state1_diff`
solves a step's u1 inside a ``torch.autograd.Function`` whose backward is
the implicit-function-theorem rule of the JAX package's ``solve_u1`` /
``solve_u1_stale`` custom VJPs (:class:`_SolveU1`): ``J(u1)^T lam = u1_bar``, then
``theta_bar = -(dR/dtheta)^T lam`` for the state, control, properties and
the step's coefficient row, on one residual graph rebuilt at u1.  Options:
``adjoint_refine`` ('stale', the default: Richardson refinement with the
window's carried factors, ``adjoint_refine_tol``/``adjoint_refine_iters``,
stopped on ``stagnation_ratio``; 'exact': full-precision factors rebuilt
at u1 and one transposed solve; 'cg' and 'bsb' always take the latter, a
transposed BiCGStab solve on K3T / K4T).

The reference's stateful API (:class:`BaseTransientModel`): each model
owns ``state0``, ``state1``, ``control`` and ``prop`` as {label: numpy
array} dicts and a time step ``dt``; ``set_*`` copy into them key by key;
``solve_state1(state1, options)`` is one step of the pure step function
above on the model's device from those values, returning numpy dicts and
an info dict of Python numbers; ``assem_res`` is the step residual at
``state1``.  The solid adds the dense block derivatives
``assem_dres_dstate1`` / ``_dstate0`` / ``_dcontrol`` (``{(row, col):
tensor}``, M5-sized as in the reference) and the Newmark-structured
solves ``solve_dres_dstate1`` / ``_adj``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from .. import ops
from ..convert import as_dict, to_numpy, to_tensors
from ..equations import newmark
from ..fem import assembly
from ..residuals.base import FemResidual, FunctionalResidual
from ..solverconst import DEFAULT_NEWTON_SOLVER_PRM, FIXEDPOINT_SOLVER_PRM
from ..solvers import bsb, btd, linalg, spike
from ..solvers.newton import SolveInfo, _select, iterative_solve, newton_solve

# solvers whose factors are built from the element Jacobian blocks, once
# per step by default: the matrix-free Newton-Krylov 'cg' (element-by-
# element operator) and 'bsb' (block-banded), both with nodal block-Jacobi,
# and the block-Thomas 'btd' and SPIKE 'spike' direct solvers on the
# block-banded Jacobian
ELEMENT_SOLVERS = ("cg", "bsb", "btd", "spike")

_SUPPORTED = {
    "linear_solver": ("dense",) + ELEMENT_SOLVERS,
    "btd_store_dtype": (None,) + tuple(btd.STORE_DTYPES),
    "btd_offdiag_dtype": (None,),
    "btd_factor_dtype": (None,),
    "krylov": ("bicgstab", "pcg"),
    "initial_guess": ("predictor", "given"),
    "jacobian_refresh_mode": ("full", "ns"),
    "jacobian_update": ("every_iteration", "once_per_step"),
    "assembly": ("auto", "banded", "plain"),
    "adjoint_refine": ("stale", "exact"),
    # the JAX package's precisions of the Newton-Schulz products, where
    # 'default' picks single-pass bfloat16 products on a TPU; here every
    # one computes them in the factors' own IEEE dtype (TF32 stays off,
    # PyTorch's default for matmuls, which the port never changes), so a
    # refresh rounds as the plain matmul does, whatever the value
    "jacobian_refresh_precision": (None, "default", "high", "highest"),
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
    Backward: the IFT rule (``SolidModel._ift_backward``); forward mode
    (``torch.func.jvp``): its tangent rule (``SolidModel._ift_jvp``).  The
    guess gets no cotangent nor tangent, nor do the factors: they were
    built without a graph from detached inputs, and the root does not
    depend on them."""

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
        ctx.save_for_forward(output[0], row, *flat)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, u1_bar, *_):
        return (None,) * 6 + ctx.solid._ift_backward(ctx, u1_bar,
                                                     ctx.needs_input_grad[6:])

    @staticmethod
    def jvp(ctx, *tangents):
        return (ctx.solid._ift_jvp(ctx, tangents[6:]), None, None, None)


class _SolveU1Batch(_SolveU1):
    """:class:`_SolveU1` of a batch of steps (``SolidModel.
    solve_state1_diff_batch``): the forward is the lockstep batched Newton
    (``SolidModel._newton_batch``), the backward the IFT rule of each
    variant at once (``SolidModel._ift_backward(batched=True)``); tangents
    of a batch are not ported."""

    @staticmethod
    def forward(solid, params_d, dt, layout, factors, guess, row, *flat):
        state0, control, prop = _unflatten(layout, flat)
        u1, info = solid._newton_batch(guess, state0, control, prop, dt, params_d,
                                       factors)
        return (u1.clone() if u1 is guess else u1, *info)

    @staticmethod
    def backward(ctx, u1_bar, *_):
        return (None,) * 6 + ctx.solid._ift_backward(ctx, u1_bar,
                                                     ctx.needs_input_grad[6:],
                                                     batched=True)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError("tangents of a batch of steps are not ported")


def _batch_params(params) -> dict:
    """:func:`solver_params` of a batched step, which solves with the dense
    solver only (the JAX package's sweep of M5-size models)."""
    p = solver_params(params)
    if p.get("linear_solver", "dense") != "dense":
        raise NotImplementedError(
            f"a batch of variants steps with linear_solver='dense' only, not"
            f" {p['linear_solver']!r}")
    return p


class _ExactSolve(torch.autograd.Function):
    """``SolidModel._exact_solve`` (forward solve) as a Function: called in
    :class:`_SolveU1`'s jvp rule, which ``torch.func.jvp`` hands its own
    tensors, it passes the solve's kernels plain ones.  Never
    differentiated itself."""

    @staticmethod
    def forward(solid, params_d, dt, layout, u1, rhs, *flat):
        return solid._exact_solve(u1, _unflatten(layout, flat), dt, params_d, rhs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


class _SolveStaticU1(torch.autograd.Function):
    """The static u1 by Newton (``SolidModel._static_newton``); backward:
    ``J(u1)^T lam = u1_bar`` by the transposed static solve at u1, then
    ``-(dR/dtheta)^T lam`` in the control and properties by a reverse pass
    over :meth:`SolidModel.res_u_static` (the JAX package's
    ``solve_static_u1`` custom VJP).  The guess gets no cotangent."""

    @staticmethod
    def forward(solid, params_d, layout, guess, *flat):
        _, control, prop = _unflatten(layout, flat)
        u1, info = solid._static_newton(guess, control, prop, params_d)
        return (u1.clone() if u1 is guess else u1, *info)

    @staticmethod
    def setup_context(ctx, inputs, output):
        solid, params_d, layout, guess, *flat = inputs
        ctx.solid, ctx.params_d, ctx.layout = solid, params_d, layout
        ctx.save_for_backward(output[0], *flat)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, u1_bar, *_):
        solid, params_d = ctx.solid, ctx.params_d
        u1, *flat = ctx.saved_tensors
        needs = ctx.needs_input_grad[4:]
        if u1_bar is None or not any(needs):
            return (None,) * (4 + len(needs))
        _, control, prop = _unflatten(ctx.layout, flat)
        lam = solid._static_solve_jac(u1, u1_bar.contiguous(), control, prop,
                                      params_d, transpose=True)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(w)) for t, w in zip(flat, needs)]
            _, control, prop = _unflatten(ctx.layout, leaves)
            r = solid.res_u_static(u1, control, prop, solid.use_banded(params_d))
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(r, wanted, -lam, allow_unused=True))
        return (None,) * 4 + tuple(next(grads) if t.requires_grad else None
                                   for t in leaves)


def copy_into(dst: dict, src) -> None:
    """Copy each block of ``src`` (a dict of arrays or tensors, or a
    BlockVector) into the numpy array of ``dst`` under the same label, in
    place: every label of ``dst`` must be in ``src``."""
    src = to_numpy(as_dict(src))
    for k, a in dst.items():
        a[...] = np.asarray(src[k]).reshape(a.shape)


def info_dict(info) -> dict:
    """A step's ``num_iter``, ``abs_err`` and ``rel_err`` as Python
    numbers, in one read from the device."""
    vals = torch.stack([torch.as_tensor(x).to(torch.float64)
                        for x in (info.num_iter, info.abs_err, info.rel_err)]).tolist()
    return {"num_iter": int(vals[0]), "abs_err": vals[1], "rel_err": vals[2]}


class BaseTransientModel:
    """One time step ``F(state1, state0, control, prop, dt)`` with the
    reference's stateful API.  ``state0``, ``state1``, ``control`` and
    ``prop`` are the model's own {label: numpy array} dicts; ``set_*``
    copy a vector into them key by key (:func:`copy_into`), so
    ``m.prop['emod'][:] = x; m.set_prop(m.prop)`` works as in the
    reference.  ``assem_res`` and ``solve_state1`` run on the model's
    device."""

    @property
    def dt(self):
        raise NotImplementedError

    def set_ini_state(self, state):
        copy_into(self.state0, state)

    def set_fin_state(self, state):
        copy_into(self.state1, state)

    def set_control(self, control):
        copy_into(self.control, control)

    def set_prop(self, prop):
        copy_into(self.prop, prop)

    def control_to_dict(self, control) -> dict:
        return to_numpy(as_dict(control))

    def prop_to_dict(self, prop) -> dict:
        return to_numpy(as_dict(prop))

    def _tensors(self, *vecs):
        """Vectors as dicts of tensors on the model's device and dtype."""
        return tuple(to_tensors(as_dict(v), self.device, self.dtype) for v in vecs)

    def assem_res(self) -> dict:
        raise NotImplementedError

    def solve_state1(self, state1, options=None):
        raise NotImplementedError


def properties_vec_from_residual(residual: FemResidual) -> dict:
    """The property vector of a residual's 'prop/*' coefficients, ``{name:
    flat numpy array}`` of their defaults, in the coefficient order."""
    defaults = residual.default_coefficients()
    return {key.split("/", 1)[1]: np.asarray(defaults[key]).reshape(-1).copy()
            for key in residual.coefficient_spec if key.startswith("prop/")}


def _contact_traction(u1, X, n, y, k):
    """Cubic-penalty contact traction at the nodes (..., nv, dim)."""
    gap = (X + u1) @ n - y
    return -(k * torch.clamp(gap, min=0.0) ** 3)[..., None] * n


class SolidElements:
    """The element arrays of a solid model and its block-banded plan, shared
    by the transient solid and the dynamical ones: ``_elem_cells``, the
    cells, then the facets' cells when the residual has a facet pass (the
    order of the Jacobian blocks); ``_elem_dofs``, their dofs."""

    def _init_elements(self):
        R = self._residual
        cells = R.mesh().cells
        self._elem_cells = [cells]
        if R.has_facet_pass():
            self._elem_cells.append(cells[R.topology.facet_cells.cpu().numpy()])
        self._elem_dofs = [assembly.cell_dof_array(c, self.dim)
                           for c in self._elem_cells]
        self._bsb = None

    def bsb_plan(self):
        """(BSBPlan, its fill plan on the device), built on first use;
        raises ``ValueError`` unless the mesh is bandwidth-ordered."""
        if self._bsb is None:
            plan = bsb.plan_bsb(self._elem_dofs, self.ndof, self._residual.bc_dofs)
            self._bsb = (plan, bsb.fill_plan(plan, self.device))
        return self._bsb


class SolidModel(SolidElements, BaseTransientModel):
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
        self.state1 = {k: np.zeros(self.ndof) for k in ("u", "v", "a")}
        self.control = {"p1": np.zeros(self.nvert)}
        self.prop = properties_vec_from_residual(R)
        self._dt = 1.0

        self._init_elements()
        # static plans, built on first use: a Krylov model never builds the
        # dense Jacobian's plan, nor a dense one the Krylov plans
        self._jac_plan = None
        self._ebe = None
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

    @property
    def solid(self):
        return self

    @property
    def XREF(self) -> np.ndarray:
        """The flat reference coordinates in dof order."""
        return np.asarray(self._residual.mesh().coords).reshape(-1)

    @property
    def dt(self):
        return self._dt

    @dt.setter
    def dt(self, value):
        self._dt = float(value)

    # -- the stateful API -------------------------------------------------------------
    def _oo_args(self):
        """The model's ``state1``, ``state0``, ``control`` and ``prop`` as
        tensors."""
        return self._tensors(self.state1, self.state0, self.control, self.prop)

    def assem_res(self) -> dict:
        """The step residual of every block at ``state1`` (the banded
        kernels where the mesh admits them)."""
        with torch.no_grad():
            return to_numpy(self.res_pure(*self._oo_args(), self.dt,
                                          self.use_banded({})))

    def assem_dres_dstate1(self) -> dict:
        """The 3x3 block Jacobian in the final state: the dense Newton
        Jacobian of the 'u' block and the Newmark identities of 'v' and
        'a' (``{(row, col): tensor}``, dense: for models of M5 size)."""
        state1, state0, control, prop = self._oo_args()
        with torch.no_grad():
            A = self.jac_u_dense(state1["u"], state0, control, prop, self.dt)
        eye = torch.eye(self.ndof, dtype=A.dtype, device=A.device)
        dt = self.dt
        return {("u", "u"): A, ("u", "v"): torch.zeros_like(A), ("u", "a"): torch.zeros_like(A),
                ("v", "u"): -newmark.newmark_v_du1(dt) * eye, ("v", "v"): eye.clone(),
                ("v", "a"): torch.zeros_like(A),
                ("a", "u"): -newmark.newmark_a_du1(dt) * eye, ("a", "v"): torch.zeros_like(A),
                ("a", "a"): eye}

    def assem_dres_dstate0(self) -> dict:
        """The 3x3 block Jacobian in the initial state: the 'u' row by
        ``jacfwd`` of the Newton residual, the 'v' and 'a' rows the Newmark
        hand derivatives."""
        state1, state0, control, prop = self._oo_args()
        banded = self.use_banded({})
        dt = self.dt
        with torch.no_grad():
            jac = jacfwd(lambda s0: self.res_u(state1["u"], s0, control, prop, dt,
                                                banded))(state0)
        eye = torch.eye(self.ndof, dtype=self.dtype, device=self.device)
        out = {("u", k): jac[k] for k in ("u", "v", "a")}
        for row, derivs in (("v", (newmark.newmark_v_du0, newmark.newmark_v_dv0,
                                   newmark.newmark_v_da0)),
                            ("a", (newmark.newmark_a_du0, newmark.newmark_a_dv0,
                                   newmark.newmark_a_da0))):
            for col, d in zip(("u", "v", "a"), derivs):
                out[row, col] = -d(dt) * eye
        return out

    def assem_dres_dcontrol(self) -> dict:
        """The block Jacobian in the control (``p1``): the 'u' row by
        ``jacfwd``, zero 'v' and 'a' rows."""
        state1, state0, control, prop = self._oo_args()
        banded = self.use_banded({})
        dt = self.dt
        with torch.no_grad():
            jac = jacfwd(lambda c: self.res_u(state1["u"], state0, c, prop, dt,
                                               banded))(control)
        out = {("u", k): v for k, v in jac.items()}
        for row in ("v", "a"):
            out.update({(row, k): torch.zeros_like(v) for k, v in jac.items()})
        return out

    def solve_dres_dstate1(self, dres_dstate1: dict, x, b) -> dict:
        """``x`` with ``dres_dstate1 x = b``: one dense solve of the 'u'
        block, then the Newmark rows explicitly.  The result is a new dict
        (the reference's ``x``, the output's template, is not read)."""
        A = dres_dstate1["u", "u"]
        (b,) = self._tensors(b)
        with torch.no_grad():
            xu = linalg.dense_solve(A, b["u"])
            xv = b["v"] - dres_dstate1["v", "u"] @ xu
            xa = b["a"] - dres_dstate1["a", "u"] @ xu
        return to_numpy({"u": xu, "v": xv, "a": xa})

    def solve_dres_dstate1_adj(self, dres_dstate1_adj: dict, x, b) -> dict:
        """``x`` with ``dres_dstate1^T x = b``: the transposed
        Newmark-structured solve (``x`` as in :meth:`solve_dres_dstate1`)."""
        J = dres_dstate1_adj
        (b,) = self._tensors(b)
        with torch.no_grad():
            rhs = b["u"] - (J["v", "u"].mT @ b["v"] + J["a", "u"].mT @ b["a"])
            xu = linalg.dense_solve_transpose(J["u", "u"], rhs)
        return to_numpy({"u": xu, "v": b["v"], "a": b["a"]})

    def solve_state1(self, state1, options=None):
        """One step from the model's ``state0`` under its ``control``,
        ``prop`` and ``dt`` (:meth:`solve_state1_pure`; ``options`` are its
        solver parameters, and ``state1`` is Newton's start only with
        ``initial_guess='given'``).  Returns ``(state1, info)``: a dict of
        numpy arrays and ``num_iter``, ``abs_err``, ``rel_err`` as Python
        numbers."""
        guess, state0, control, prop = self._tensors(state1, self.state0,
                                                     self.control, self.prop)
        with torch.no_grad():
            out, info = self.solve_state1_pure(state0, control, prop, self.dt,
                                               options, guess=guess)
        return to_numpy(out), info_dict(info)

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

    def res_pure(self, state1, state0, control, prop, dt, banded=False):
        """The step residual of every block at ``state1``: the Newton 'u'
        residual, and the Newmark identities of 'v' and 'a'."""
        u1 = state1["u"].reshape(self.nvert, self.dim)
        u0, v0, a0 = self._state0_2d(state0)
        k = newmark_coefs(dt)
        return {
            "u": self.res_u(state1["u"], state0, control, prop, dt, banded),
            "v": state1["v"] - newmark.velocity_k(u1, u0, v0, a0, k).reshape(-1),
            "a": state1["a"] - newmark.acceleration_k(u1, u0, v0, a0, k).reshape(-1),
        }

    def jac_u_blocks(self, u1_flat, state0, control, prop, dt):
        """Per-element Jacobian blocks (Jc, Jf) of the Newton 'u' residual,
        by ``vmap(jacfwd(element residual))``."""
        return self._jac_blocks(u1_flat, state0, control, prop, dt)

    def _jac_blocks(self, u1_flat, state0, control, prop, dt):
        """:meth:`jac_u_blocks`, or with ``state0`` None the static blocks
        (:meth:`jac_u_static_blocks`: v1 = a1 = 0, held)."""
        R = self._residual
        topo = R.topology
        cells = topo.cells
        nld = cells.shape[1] * self.dim
        u1 = u1_flat.reshape(self.nvert, self.dim)
        prop_fields = self._prop_fields(prop)
        X = self.coords(prop_fields)
        fields = self._full_fields(u1, torch.zeros_like(u1),
                                   torch.zeros_like(u1), control, prop_fields)
        cell_elem = R.cell_elem_fn()
        facet_elem = R.facet_elem_fn()
        has_contact = self._has_contact
        if state0 is None:
            u0 = v0 = a0 = None

            def with_state(loc, u1_e, s0_e):
                loc = dict(loc)
                loc["state/u1"] = u1_e
                loc["state/v1"] = torch.zeros_like(u1_e)
                loc["state/a1"] = torch.zeros_like(u1_e)
                return loc
        else:
            u0, v0, a0 = self._state0_2d(state0)

            def with_state(loc, u1_e, s0_e):
                u0_e, v0_e, a0_e = s0_e
                loc = dict(loc)
                loc["state/u1"] = u1_e
                loc["state/v1"] = newmark.newmark_v(u1_e, u0_e, v0_e, a0_e, dt)
                loc["state/a1"] = newmark.newmark_a(u1_e, u0_e, v0_e, a0_e, dt)
                return loc

        def elem_state(idx):
            # the per-element state0 (none for the static blocks)
            return () if u0 is None else (u0[idx], v0[idx], a0[idx])

        def cell_fn(u1_e, Xe, s0_e, local):
            return cell_elem(Xe, with_state(local, u1_e, s0_e))

        local_c, axes_c = R.gather_cell_locals(fields)
        Jc = vmap(jacfwd(cell_fn), in_dims=(0, 0, 0, axes_c))(
            u1[cells], X[cells], elem_state(cells), local_c
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
            elem_state(cv), local_f,
        ).reshape(-1, nld, nld)
        return Jc, Jf

    def jac_u_dense(self, u1_flat, state0, control, prop, dt):
        """Dense Newton Jacobian with identity Dirichlet rows."""
        return self._dense_from_blocks(
            self.jac_u_blocks(u1_flat, state0, control, prop, dt))

    def _dense_from_blocks(self, blocks):
        """The dense matrix of element Jacobian blocks (Jc, Jf), with
        identity Dirichlet rows."""
        blocks = [b for b in blocks if b is not None]
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

    def make_iter_factors(self, u_lin, state0, control, prop, dt, params_d):
        """Frozen factors at ``u_lin`` from the element Jacobian blocks:
        the block-Thomas factors of the block-banded Jacobian ('btd'), or
        the Krylov operator with its block-Jacobi inverse ('cg' | 'bsb')."""
        op = self.jac_u_ebe(u_lin, state0, control, prop, dt)
        ls = params_d.get("linear_solver")
        if ls in ("bsb", "btd", "spike"):
            plan, fill = self.bsb_plan()
            blocks = bsb.bsb_fill(plan, fill, [op.J_cells, op.J_facets])
            if ls == "btd":
                return btd.btd_factor(
                    plan, blocks, store_dtype=params_d.get("btd_store_dtype")
                )
            if ls == "spike":
                return spike.spike_factor(
                    plan, blocks, int(params_d.get("spike_partitions", 8)),
                    store_dtype=params_d.get("btd_store_dtype"),
                )
            return KrylovFactors(blocks, op.block_diag_inverse(self.dim))
        return KrylovFactors(op, op.block_diag_inverse(self.dim))

    def iter_solve(self, factors, r, params_d, transpose=False):
        """Solve with frozen Krylov factors: block-Jacobi BiCGStab (default;
        the Jacobian is nonsymmetric through the follower-pressure terms)
        or PCG (``krylov='pcg'``).  ``transpose`` solves ``A^T x = r`` (the
        adjoint solves) with the transposed operator (K4T for 'bsb', K3T
        for 'cg'), by BiCGStab whatever ``krylov`` says, preconditioned by
        the same block-Jacobi inverse (the JAX package's ``_iter_solve``)."""
        A, Dinv = factors
        if params_d.get("linear_solver") == "bsb":
            plan, fill = self.bsb_plan()
            mv, pattern = ((ops.bsb_matvec_t, fill.pattern_t) if transpose
                           else (ops.bsb_matvec, fill.pattern))

            def matvec(v):
                return mv(plan, A, v, pattern)
        else:
            matvec = A.matvec_transpose if transpose else A.matvec
        pcg = params_d.get("krylov", "bicgstab") == "pcg" and not transpose
        result = (linalg.pcg if pcg else linalg.bicgstab)(
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

    def _initial_guess(self, guess, state0, dt, params_d):
        """Newton's start: the Newmark predictor (:meth:`_predictor`), or
        with ``initial_guess='given'`` the state1 guess ``guess['u']``
        (the implicit coupling's Picard iterate), which neither reads nor
        counts the carried predictor."""
        if params_d.get("initial_guess", "predictor") == "given":
            if guess is None:
                raise ValueError("initial_guess='given' needs a state1 guess")
            return guess["u"]
        return self._predictor(state0, dt)

    def solve_state1_pure(self, state0, control, prop, dt, params=None,
                          dt_next=None, guess=None):
        """One time step from the Newmark predictor, or from ``guess``
        (a state1 dict) with ``initial_guess='given'``.  The Jacobian is
        re-assembled every iteration (the dense default) or once per step
        (the default of the element-block solvers 'cg', 'bsb', 'btd').
        ``dt_next``, the next step's dt where known, is the step of the
        predictor K5 writes with the state."""
        params_d = solver_params(params)
        u_guess = self._initial_guess(guess, state0, dt, params_d)
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
        if isinstance(factors, spike.SPIKEFactors):
            return spike.spike_solve(self.bsb_plan()[0], factors, r)
        if isinstance(factors, KrylovFactors):
            return self.iter_solve(factors, r, params_d)
        return linalg.dense_factor_solve(factors, r)

    def refresh_factors(self, factors, state0, control, prop, dt,
                        params=None):
        """Newton-Schulz refresh of carried factors toward the Jacobian at
        the current predictor; the block-Thomas and Krylov factors are
        rebuilt from the element Jacobian blocks."""
        params_d = solver_params(params)
        if isinstance(factors, (btd.BTDFactors, spike.SPIKEFactors,
                                KrylovFactors)):
            return self.factorize(state0, control, prop, dt, params_d)
        u_lin = self._predictor(state0, dt)
        A = self.jac_u_dense(u_lin, state0, control, prop, dt)
        iters = int(params_d.get("jacobian_refresh_iters", 2))
        return linalg.dense_refresh(factors, A, iters)

    def solve_state1_stale(self, factors, state0, control, prop, dt,
                           params=None, dt_next=None, guess=None):
        """One time step with carried (stale) Jacobian factors (``dt_next``
        and ``guess`` as in :meth:`solve_state1_pure`)."""
        params_d = solver_params(params)
        u_guess = self._initial_guess(guess, state0, dt, params_d)
        u1, info = self._newton(u_guess, state0, control, prop, dt, params_d,
                                factors)
        return self._finish(u1, state0, dt, dt_next), info

    # -- a batch of variants ---------------------------------------------------------
    def solve_state1_batch(self, state0, control, prop, dt, params=None,
                           dt_next=None, factors=None):
        """One time step of a batch of variants (a leading batch axis on
        every tensor of ``state0``, ``control`` and ``prop``): Newton from
        the Newmark predictor on the batch (:meth:`_newton_batch`), with
        carried ``factors`` where given, then K5 over the batch.  Returns
        the state and a ``SolveInfo`` of (B,) tensors."""
        params_d = _batch_params(params)
        u_guess = self._initial_guess(None, state0, dt, params_d)
        u1, info = self._newton_batch(u_guess, state0, control, prop, dt, params_d,
                                      factors)
        return self._finish(u1, state0, dt, dt_next), info

    def _vmapped_jac(self, dt, fn):
        """``vmap`` of ``fn(dense Jacobian at u1, *args)`` over ``(u1,
        state0, control, prop, *args)``."""
        return vmap(lambda u1, s0, c, p, *args: fn(self.jac_u_dense(u1, s0, c, p, dt), *args))

    def _newton_batch(self, u_guess, state0, control, prop, dt, params_d,
                      factors=None):
        """:meth:`_newton` of a batch: the lockstep batched Newton over the
        vmapped residual, solving with the batch's carried ``factors``, or
        factors built in the step (``jacobian_update='once_per_step'``), or
        the dense Jacobian at each iterate."""
        banded = self.use_banded(params_d)
        res = vmap(lambda u1, s0, c, p: self.res_u(u1, s0, c, p, dt, banded))

        def assem(u1):
            return res(u1, state0, control, prop)

        if factors is None and params_d.get("jacobian_update") == "once_per_step":
            factors = self.factorize_batch(state0, control, prop, dt, params_d)
        if factors is None:
            solve = self._vmapped_jac(dt, linalg.dense_solve)

            def solve_jac(u1, r):
                return solve(u1, state0, control, prop, r)
        else:
            solve_f = vmap(linalg.dense_factor_solve)

            def solve_jac(u1, r):
                return solve_f(factors, r)

        return newton_solve(u_guess, assem, solve_jac, params_d, batched=True)

    def factorize_batch(self, state0, control, prop, dt, params=None):
        """:meth:`factorize` of a batch: the equilibrated explicit inverse
        of each variant's Jacobian at its predictor."""
        _batch_params(params)
        u_lin = self._predictor(state0, dt)
        return self._vmapped_jac(dt, linalg.dense_factor)(u_lin, state0, control, prop)

    def refresh_factors_batch(self, factors, state0, control, prop, dt, params=None):
        """:meth:`refresh_factors` of a batch: each variant's Newton-Schulz
        refresh toward its Jacobian at its predictor."""
        params_d = _batch_params(params)
        u_lin = self._predictor(state0, dt)
        iters = int(params_d.get("jacobian_refresh_iters", 2))

        def refresh(A, f):
            return linalg.dense_refresh(f, A, iters)

        return self._vmapped_jac(dt, refresh)(u_lin, state0, control, prop, factors)

    def solve_state1_diff_batch(self, state0, control, prop, dt, row, params=None,
                                factors=None):
        """:meth:`solve_state1_diff` of a batch (leading batch axes as in
        :meth:`solve_state1_batch`; one coefficient row for the batch):
        u1 by :class:`_SolveU1Batch`, then K5 over the batch under
        ``ops.newmark_step`` (K5T's batched launch backward, a row
        cotangent a variant, summed over the batch for the shared row)."""
        params_d = _batch_params(params)
        u0, v0, a0 = (state0[k] for k in ("u", "v", "a"))
        guess = newmark.newmark_predict_u(u0.detach(), v0.detach(), a0.detach(), dt)
        layout, flat = _flatten(state0, control, prop)
        out = _SolveU1Batch.apply(self, params_d, dt, layout, factors, guess, row, *flat)
        v1, a1, _ = ops.newmark_step(out[0], u0, v0, a0, row)
        return {"u": out[0], "v": v1, "a": a1}, SolveInfo(*out[1:])

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
        for bit; nothing is carried between steps.  ``linear_solver=
        'spike'`` raises: its transposed solve is not ported."""
        params_d = solver_params(params)
        if params_d.get("linear_solver") == "spike":
            raise NotImplementedError(spike.TRANSPOSE_TODO)
        u0, v0, a0 = (state0[k] for k in ("u", "v", "a"))
        guess = newmark.newmark_predict_u(u0.detach(), v0.detach(),
                                          a0.detach(), dt)
        layout, flat = _flatten(state0, control, prop)
        out = _SolveU1.apply(self, params_d, dt, layout, factors, guess, row,
                             *flat)
        u1 = out[0]
        v1, a1, _ = ops.newmark_step(u1, u0, v0, a0, row)
        return {"u": u1, "v": v1, "a": a1}, SolveInfo(*out[1:])

    def _ift_backward(self, ctx, u1_bar, needs, batched=False):
        """The IFT rule of one step: with ``J = dR/du1`` at the saved u1,
        solve ``J^T lam = u1_bar`` (:meth:`_adjoint_solve`) and return
        ``-(dR/dtheta)^T lam`` for the row and each flat input that
        ``needs`` a gradient (None for the others).  Every ``J^T v`` and
        the final product are reverse passes over one residual graph
        rebuilt at u1, so the banded kernels K1 and K2 run through each
        other's backward.  ``batched``: a batch of steps (leading batch
        axes, one row), the residual vmapped over it; each variant's
        residual depends on its own inputs only, so one reverse pass gives
        every variant's ``J^T v``, and the row's cotangent is the batch's
        sum."""
        u1, row, *flat = ctx.saved_tensors
        params_d, layout = ctx.params_d, ctx.layout
        if u1_bar is None or not any(needs):
            return (None,) * len(needs)
        banded = self.use_banded(params_d)
        # only the residual is recorded: the solves below run without a
        # graph (grad mode is off in backward), or factors built at u1
        # would keep one alive
        with torch.enable_grad():
            u = u1.detach().requires_grad_()
            leaves = [t.detach().requires_grad_(bool(w))
                      for t, w in zip((row, *flat), needs)]
            coefs = StepCoefs(leaves[0], self.dtype)

            def res(u_, *flat_):
                return self.res_u(u_, *_unflatten(layout, flat_), coefs, banded)

            r = (vmap(res) if batched else res)(u, *leaves[1:])

        def JT(v):
            return torch.autograd.grad(r, u, v, retain_graph=True)[0]

        detached = _unflatten(layout, [t.detach() for t in flat])
        lam = self._adjoint_solve(JT, u1.detach(), detached, ctx.dt, params_d,
                                  ctx.factors, u1_bar.contiguous(), batched)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(r, wanted, -lam, allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)

    def _ift_jvp(self, ctx, tangents):
        """The forward-mode IFT rule of one step (the JAX package's
        ``solve_u1_fwdmode`` custom JVP): ``R_dot = dR/dtheta theta_dot`` by
        ``torch.func.jvp`` of the residual at the saved u1 (the banded path:
        K1 and K2 on the tangent), then ``u1_dot = -J(u1)^{-1} R_dot`` with
        full-precision factors built at u1 (:meth:`_exact_solve`: the
        tangent is one uncorrected solve, so bf16 block-Thomas factors are
        never used for it, nor the window's carried factors)."""
        u1, row, *flat = ctx.saved_tensors
        params_d, layout = ctx.params_d, ctx.layout
        banded = self.use_banded(params_d)

        def res(row_, *flat_):
            state0, control, prop = _unflatten(layout, flat_)
            return self.res_u(u1, state0, control, prop,
                              StepCoefs(row_, self.dtype), banded)

        primals = (row, *flat)
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents))
        _, r_dot = jvp(res, primals, tangents)
        return -_ExactSolve.apply(self, params_d, ctx.dt, layout, u1, r_dot, *flat)

    def _adjoint_solve(self, JT, u1, inputs, dt, params_d, factors, u1_bar,
                       batched=False):
        """``lam`` with ``J(u1)^T lam = u1_bar``: refined with the carried
        ``factors`` (``adjoint_refine='stale'``, the default where there
        are dense or block-Thomas factors), else one transposed solve with
        full-precision factors built at u1 (the JAX package's 'exact' mode
        and its rule for a step that factors itself, and for the Krylov
        solvers 'cg' and 'bsb' always: a transposed BiCGStab solve).
        ``batched``: a batch of dense steps, each variant's solve its own
        (:meth:`_refined_adjoint`, or the vmapped transposed dense
        solve)."""
        self.adjoint_counts["solves"] += 1
        krylov = params_d.get("linear_solver", "dense") in ("cg", "bsb")
        refine = (factors is not None and not krylov
                  and params_d.get("adjoint_refine", "stale") == "stale")
        if batched:
            if refine:
                return self._refined_adjoint(JT, factors, u1_bar, params_d, batched=True)
            return self._vmapped_jac(dt, linalg.dense_solve_transpose)(u1, *inputs, u1_bar)
        if refine:
            return self._refined_adjoint(JT, factors, u1_bar, params_d)
        return self._exact_solve(u1, inputs, dt, params_d, u1_bar, transpose=True)

    def _exact_solve(self, u1, inputs, dt, params_d, rhs, transpose=False):
        """``J(u1)^{-1} rhs`` (``J(u1)^{-T} rhs`` with ``transpose``) with
        factors built at u1 in full precision (``btd_store_dtype``
        dropped): one uncorrected solve, the adjoint's and the tangent's
        (the JAX package's ``solve_u1`` rules): a block-Thomas solve
        ('btd', K6 / K6T), a Krylov solve to ``krylov_tolerance`` ('cg',
        'bsb'), or a dense LU solve."""
        state0, control, prop = inputs
        ls = params_d.get("linear_solver", "dense")
        if ls in ELEMENT_SOLVERS:
            exact = {k: v for k, v in params_d.items() if k != "btd_store_dtype"}
            fac = self.make_iter_factors(u1, state0, control, prop, dt, exact)
            if ls == "btd":
                solve = btd.btd_solve_t if transpose else btd.btd_solve
                return solve(self.bsb_plan()[0], fac, rhs)
            return self.iter_solve(fac, rhs, params_d, transpose)
        A = self.jac_u_dense(u1, state0, control, prop, dt)
        return (linalg.dense_solve_transpose if transpose else linalg.dense_solve)(A, rhs)

    def solve_factors_t(self, factors, r):
        """Carried factors applied as a transposed preconditioner,
        ``M^-T r`` (block-Thomas factors or the dense inverse)."""
        if isinstance(factors, btd.BTDFactors):
            return btd.btd_solve_t(self.bsb_plan()[0], factors, r)
        return linalg.dense_factor_solve_t(factors, r)

    def _refined_adjoint(self, JT, factors, u1_bar, params_d, batched=False):
        """Richardson iteration ``lam += M^-T (u1_bar - J^T lam)`` with the
        carried factors as ``M`` (``refined_adjoint_solve`` of the JAX
        package): it keeps the lowest-residual iterate and stops below
        ``adjoint_refine_tol`` relative to ``|u1_bar|``, when an iteration
        fails to reduce the residual by ``stagnation_ratio``, or after
        ``adjoint_refine_iters`` iterations.  ``batched``: a batch of
        variants (rows) in lockstep, each with its own norms, test and
        lowest-residual iterate (the JAX package's loop under ``vmap``);
        unbatched, the same loop at rank 0.  One host read an iteration,
        of whether any variant goes on; the tests compare in float64, as
        :func:`solvers.newton.newton_solve`'s do."""
        tol = params_d.get("adjoint_refine_tol", 1e-8)
        max_it = int(params_d.get("adjoint_refine_iters", 25))
        stag = params_d.get("stagnation_ratio", 0.9)
        if batched:
            solve_b = vmap(linalg.dense_factor_solve_t)

            def solve_t(r):
                return solve_b(factors, r)

            def norm(x):
                return torch.linalg.vector_norm(x, dim=-1)
        else:
            def solve_t(r):
                return self.solve_factors_t(factors, r)

            norm = torch.linalg.vector_norm

        bound = tol * norm(u1_bar).double()
        lam = solve_t(u1_bar)
        r = u1_bar - JT(lam)
        rn = norm(r)
        rn_prev = torch.full_like(rn, float("inf"))
        lam_best, rn_best = lam, rn
        k = torch.zeros(rn.shape, dtype=torch.int64, device=rn.device)

        def active():
            e = rn.double()
            return (e >= bound) & (e < stag * rn_prev.double()) & (k < max_it)

        act = active()
        while bool(act.any()):
            lam_new = lam + solve_t(r)
            r_new = u1_bar - JT(lam_new)
            rn_new = norm(r_new)
            better = act & (rn_new < rn_best)
            lam_best = _select(better, lam_new, lam_best)
            rn_best = torch.where(better, rn_new, rn_best)
            lam = _select(act, lam_new, lam)
            r = _select(act, r_new, r)
            rn_prev = torch.where(act, rn, rn_prev)
            rn = torch.where(act, rn_new, rn)
            k = k + act.to(k.dtype)
            act = active()
        self.adjoint_counts["refine_iterations"] += int(k.sum())
        return lam_best

    # -- the static problem (v1 = a1 = 0) ----------------------------------------
    def res_u_static(self, u1_flat, control, prop, banded=False):
        """The static residual: the 'u' form at ``u1`` with v1 = a1 = 0;
        Dirichlet rows read ``u1``."""
        u1 = u1_flat.reshape(self.nvert, self.dim)
        z = torch.zeros_like(u1)
        fields = self._full_fields(u1, z, z, control, self._prop_fields(prop))
        res = self._residual.assemble_res(fields, banded=banded).reshape(-1)
        return res * (1.0 - self._bc_mask) + u1_flat * self._bc_mask

    def jac_u_static_blocks(self, u1_flat, control, prop):
        """Per-element blocks (Jc, Jf) of the static Jacobian in u1, with v1
        and a1 held at zero (the transient blocks add the Newmark terms)."""
        return self._jac_blocks(u1_flat, None, control, prop, None)

    def jac_u_static_dense(self, u1_flat, control, prop):
        """The dense static Jacobian with identity Dirichlet rows."""
        return self._dense_from_blocks(
            self.jac_u_static_blocks(u1_flat, control, prop))

    def _static_solve_jac(self, u1, r, control, prop, params_d, transpose=False):
        """``J(u1)^{-1} r`` of the static Jacobian (``J^{-T} r`` with
        ``transpose``), factored at ``u1``: block-Thomas on the block-banded
        fill (``linear_solver='btd'``: K6, K6T with ``transpose``; its plan
        warns on a mesh that is not bandwidth-ordered), else a dense LU
        solve."""
        if params_d.get("linear_solver", "dense") == "btd":
            Jc, Jf = self.jac_u_static_blocks(u1, control, prop)
            plan, fill = self.bsb_plan()
            blocks = bsb.bsb_fill(plan, fill, [Jc.contiguous(),
                                               None if Jf is None else Jf.contiguous()])
            fac = btd.btd_factor(plan, blocks,
                                 store_dtype=params_d.get("btd_store_dtype"))
            return (btd.btd_solve_t if transpose else btd.btd_solve)(plan, fac, r)
        A = self.jac_u_static_dense(u1, control, prop)
        return (linalg.dense_solve_transpose if transpose else linalg.dense_solve)(A, r)

    def solve_static_u1(self, u_guess, control, prop, params=None):
        """The static u1 by Newton from ``u_guess`` (the Jacobian rebuilt
        every iteration), ``(u1, SolveInfo)``: a differentiable function
        of ``control`` and ``prop`` (:class:`_SolveStaticU1`, whose backward
        is the transposed static solve, then the vjp of
        :meth:`res_u_static`)."""
        layout, flat = _flatten({}, control, prop)
        out = _SolveStaticU1.apply(self, solver_params(params), layout, u_guess, *flat)
        return out[0], SolveInfo(*out[1:])

    def _static_newton(self, u_guess, control, prop, params_d):
        banded = self.use_banded(params_d)

        def assem(u1):
            return self.res_u_static(u1, control, prop, banded)

        def solve_jac(u1, r):
            return self._static_solve_jac(u1, r, control, prop, params_d)

        return newton_solve(u_guess, assem, solve_jac, params_d)


class FluidModel(BaseTransientModel):
    """Quasi-steady fluid wrapping a :class:`FunctionalResidual`."""

    def __init__(self, residual: FunctionalResidual):
        self._residual = residual
        self.device, self.dtype = residual.device, residual.dtype
        state, control, prop = residual.res_args
        self.state0 = {k: np.array(v, dtype=float) for k, v in state.items()}
        self.state1 = {k: v.copy() for k, v in self.state0.items()}
        self.control = {k: np.array(v, dtype=float) for k, v in control.items()}
        self.prop = {k: np.array(v, dtype=float) for k, v in prop.items()}
        self._dt = 1.0

    @property
    def residual(self) -> FunctionalResidual:
        return self._residual

    @property
    def fluid(self):
        return self

    @property
    def dt(self):
        return self._dt

    @dt.setter
    def dt(self, value):
        self._dt = value

    def assem_res(self) -> dict:
        """The fluid residual at ``state1``."""
        state1, control, prop = self._tensors(self.state1, self.control, self.prop)
        with torch.no_grad():
            return to_numpy(self.res_pure(state1, control, prop))

    def solve_state1(self, state1=None, options=None):
        """The quasi-steady state under the model's ``control`` and
        ``prop`` (it depends on no state); the info is empty."""
        proto, control, prop = self._tensors(self.state1, self.control, self.prop)
        with torch.no_grad():
            return to_numpy(self.solve_pure(control, prop, proto)), {}

    def res_pure(self, state, control, prop):
        """The fluid residual at ``state``."""
        return self._residual.res(state, control, prop)

    def solve_pure(self, control, prop, state_proto):
        """Quasi-steady solve: state1 = state - res(state, g, p), which does
        not depend on ``state``."""
        zero = {k: torch.zeros_like(v) for k, v in state_proto.items()}
        r = self._residual.res(zero, control, prop)
        return {k: zero[k] - r[k] for k in zero}


def pressure_to_solid(p_fluid: torch.Tensor, nvert: int, solid_dofs: torch.Tensor,
                      fluid_dofs: torch.Tensor) -> torch.Tensor:
    """The fluid pressure at the interface as a solid vertex field (zero
    elsewhere): the fluid-to-solid coupling map."""
    out = p_fluid.new_zeros((nvert,))
    out[solid_dofs] = p_fluid[fluid_dofs]
    return out


def area_from_surface(x: torch.Tensor, ymid, n_area: int, solid_dofs: torch.Tensor,
                      fluid_dofs: torch.Tensor) -> torch.Tensor:
    """The fluid area ``2*(ymid - y)`` at the interface vertices of the
    current solid coordinates ``x`` (nvert, dim): the solid-to-fluid
    coupling map."""
    solid_area = 2.0 * (ymid - x[:, 1])
    area = solid_area.new_zeros((n_area,))
    area[fluid_dofs] = solid_area[solid_dofs]
    return area


class ExplicitFSIModel(BaseTransientModel):
    """Staggered explicit coupling: the solid sees the previous step's
    fluid pressure; the fluid sees the current step's solid geometry.

    State ``{u, v, a, q, p}``; control ``{psub, psup}``; props = solid props
    + fluid props + the coupling midline ``ymid``.  ``dt`` is the solid's
    and the fluid's; :meth:`set_prop` also sets each submodel's
    properties."""

    def __init__(self, solid: SolidModel, fluid: FluidModel,
                 solid_fsi_dofs: np.ndarray, fluid_fsi_dofs: np.ndarray):
        self.solid = solid
        self.fluid = fluid
        self.device, self.dtype = solid.device, solid.dtype
        self.state0 = {
            **{k: v.copy() for k, v in solid.state0.items()},
            **{k: v.copy() for k, v in fluid.state0.items()},
        }
        self.state1 = {
            **{k: v.copy() for k, v in solid.state1.items()},
            **{k: v.copy() for k, v in fluid.state1.items()},
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

    # -- the stateful API -------------------------------------------------------------
    @property
    def dt(self):
        return self.solid.dt

    @dt.setter
    def dt(self, value):
        self.solid.dt = value
        self.fluid.dt = value

    def set_prop(self, prop):
        copy_into(self.prop, prop)
        self.solid.set_prop({k: self.prop[k] for k in self._solid_prop_keys})
        self.fluid.set_prop({k: self.prop[k] for k in self._fluid_prop_keys})

    def solve_state1(self, state1, options=None):
        """One coupled step from the model's ``state0`` under its
        ``control``, ``prop`` and ``dt`` (:meth:`step_pure`; ``state1`` is
        the solid's Newton start with ``initial_guess='given'``, and the
        implicit coupling's first Picard iterate).  Returns ``(state1,
        info)``: numpy arrays and Python numbers."""
        guess, state0, control, prop = self._tensors(state1, self.state0,
                                                     self.control, self.prop)
        with torch.no_grad():
            out, info = self.step_pure(state0, control, prop, self.dt, options,
                                       guess=guess)
        return to_numpy(out), info_dict(info)

    def assem_res(self) -> dict:
        """The step residual of every block at ``state1``."""
        args = self._tensors(self.state1, self.state0, self.control, self.prop)
        with torch.no_grad():
            return to_numpy(self.res_pure(*args, self.dt,
                                          banded=self.solid.use_banded({})))

    # -- coupling maps ----------------------------------------------------------
    def _pressure_to_solid(self, p_fluid: torch.Tensor) -> torch.Tensor:
        return pressure_to_solid(p_fluid, self.solid.nvert, self._solid_dofs,
                                 self._fluid_dofs)

    def _area_from_u1(self, u1_flat: torch.Tensor, prop: dict) -> torch.Tensor:
        """fluid area = 2*(ymid - y_surface)."""
        u1 = u1_flat.reshape(self.solid.nvert, self.solid.dim)
        sl_prop, _ = self._split_prop(prop)
        X = self.solid.coords(self.solid._prop_fields(sl_prop))
        return area_from_surface(X + u1, prop["ymid"][0], self._n_area,
                                 self._solid_dofs, self._fluid_dofs)

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

    def res_pure(self, state1, state0, control, prop, dt, banded=False):
        """The staggered step's residual of every block at ``state1``: the
        solid's under the previous step's pressure, the fluid's on the
        current geometry."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        res = self.solid.res_pure({k: state1[k] for k in ("u", "v", "a")},
                                  sl_state0, sl_control, sl_prop, dt, banded)
        _, fl_prop = self._split_prop(prop)
        area = self._area_from_u1(state1["u"], prop)
        fl_control = {"area": area, **{k: control[k] for k in control}}
        res.update(self.fluid.res_pure({"q": state1["q"], "p": state1["p"]},
                                       fl_control, fl_prop))
        return res

    # -- pure step functions ------------------------------------------------------
    def step_pure(self, state0, control, prop, dt, params=None, dt_next=None,
                  guess=None):
        """One coupled step, re-assembling the Jacobian in each solve;
        ``dt_next``, the next step's dt where known, is the step of the
        predictor written with the state (``SolidModel._finish``);
        ``guess``, a state1 dict, is Newton's start with
        ``initial_guess='given'``."""
        sl_state0, sl_control, sl_prop = self._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_pure(
            sl_state0, sl_control, sl_prop, dt, params, dt_next, guess
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

    # -- a batch of variants ------------------------------------------------------
    def _solid_inputs_batch(self, state0, prop):
        """:meth:`_solid_inputs` of a batch: the solid's state and property
        tensors themselves (K5's carried predictor is kept with the
        state's very tensors), the pressure map vmapped."""
        sl_prop, _ = self._split_prop(prop)
        p_solid = vmap(self._pressure_to_solid)(state0["p"])
        return {k: state0[k] for k in ("u", "v", "a")}, {"p1": p_solid}, sl_prop

    def step_batch(self, state0, control, prop, dt, params=None, dt_next=None):
        """:meth:`step_pure` of a batch of variants: a leading batch axis on
        every tensor of ``state0``, ``control`` and ``prop``
        (``SolidModel.solve_state1_batch``, then the vmapped fluid step)."""
        return self.step_batch_stale(None, state0, control, prop, dt, params, dt_next)

    def step_batch_stale(self, factors, state0, control, prop, dt, params=None,
                         dt_next=None):
        """:meth:`step_pure_stale` of a batch, with the batch's carried
        factors (:meth:`factorize_batch`); None: as :meth:`step_batch`."""
        sl_state0, sl_control, sl_prop = self._solid_inputs_batch(state0, prop)
        uva1, info = self.solid.solve_state1_batch(sl_state0, sl_control, sl_prop, dt,
                                                   params, dt_next, factors)
        return vmap(self._fluid_step)(uva1, state0, control, prop), info

    def factorize_batch(self, state0, control, prop, dt, params=None):
        return self.solid.factorize_batch(*self._solid_inputs_batch(state0, prop), dt,
                                          params)

    def refresh_factors_batch(self, factors, state0, control, prop, dt, params=None):
        return self.solid.refresh_factors_batch(
            factors, *self._solid_inputs_batch(state0, prop), dt, params)

    def step_diff_batch(self, state0, control, prop, dt, row, params=None,
                        factors=None):
        """:meth:`step_diff` of a batch (``SolidModel.
        solve_state1_diff_batch``, then the vmapped fluid step)."""
        sl_state0, sl_control, sl_prop = self._solid_inputs_batch(state0, prop)
        uva1, info = self.solid.solve_state1_diff_batch(
            sl_state0, sl_control, sl_prop, dt, row, params, factors)
        return vmap(self._fluid_step)(uva1, state0, control, prop), info


# tangents a vmapped jvp pushes at once where the coupled Jacobian of
# ImplicitFSIModel's IFT rule is built (bounds the batched residual's memory)
COUPLED_JAC_CHUNK = 256


class _ImplicitStep(torch.autograd.Function):
    """One Picard step of :class:`ImplicitFSIModel` (with a window's
    carried ``factors``, or factors built in the step), run without a
    graph.  Backward: the coupled IFT rule (``ImplicitFSIModel._ift_vjp``);
    forward mode: its tangent rule (``_ift_jvp``).  The factors get no
    cotangent nor tangent: the converged state does not depend on them."""

    @staticmethod
    def forward(model, params_d, dt, layout, factors, row, *flat):
        state0, control, prop = _unflatten(layout, flat)
        if factors is None:
            x, info = model.step_pure(state0, control, prop, dt, params_d)
        else:
            x, info = model.step_pure_stale(factors, state0, control, prop, dt,
                                            params_d)
        # a Picard loop that takes no iteration returns its guess, the inputs
        outs = tuple(x[k].clone() if any(x[k] is t for t in flat) else x[k]
                     for k in model.state0)
        return (*outs, *info)

    @staticmethod
    def setup_context(ctx, inputs, output):
        model, params_d, dt, layout, factors, row, *flat = inputs
        ctx.model, ctx.params_d, ctx.layout = model, params_d, layout
        n = len(model.state0)
        ctx.save_for_backward(*output[:n], row, *flat)
        ctx.save_for_forward(*output[:n], row, *flat)
        ctx.mark_non_differentiable(*output[n:])

    @staticmethod
    def backward(ctx, *cotangents):
        n = len(ctx.model.state0)
        return (None,) * 5 + ctx.model._ift_vjp(ctx, cotangents[:n],
                                                ctx.needs_input_grad[5:])

    @staticmethod
    def jvp(ctx, *tangents):
        return (*ctx.model._ift_jvp(ctx, tangents[5:]), None, None, None)


class ImplicitFSIModel(ExplicitFSIModel):
    """Implicit coupling by fixed-point (Picard) iteration between the solid
    and the fluid (``solvers.newton.iterative_solve``): the solid sees the
    current iterate's pressure.  The Picard loop takes
    ``FIXEDPOINT_SOLVER_PRM`` with only ``aitken`` and ``aitken_omega0``
    from the caller's parameters; each iteration's solid solve takes the
    caller's parameters with ``initial_guess='given'`` (Newton from the
    iterate's u); the first iterate is the step's initial state.
    ``factorize`` and ``refresh_factors`` are the explicit model's (the
    solid at the initial state's pressure).  The Picard stop reads each
    iteration's residual norm on the host, so the steps run eagerly.

    The gradient path (:meth:`step_diff`) is the coupled IFT rule on the
    dense Jacobian of :meth:`res_pure` over the whole state, built by
    ``jacfwd``: for models of M5 size.  ``picard_counts`` counts steps,
    Picard iterations and the solid solves' Newton iterations (a tensor on
    the model's device once a solve added to it)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.picard_counts = {"steps": 0, "iterations": 0, "newton_iterations": 0}

    def _no_batch(self, *args, **kwargs):
        raise NotImplementedError("a batch of implicitly coupled variants is not ported")

    step_batch = step_batch_stale = step_diff_batch = _no_batch
    factorize_batch = refresh_factors_batch = _no_batch

    def res_pure(self, state1, state0, control, prop, dt, banded=False):
        """The coupled residual of every block at ``state1``: the solid's
        under ``state1``'s pressure, the fluid's on ``state1``'s geometry."""
        sl_prop, fl_prop = self._split_prop(prop)
        res = self.solid.res_pure(
            {k: state1[k] for k in ("u", "v", "a")},
            {k: state0[k] for k in ("u", "v", "a")},
            {"p1": self._pressure_to_solid(state1["p"])}, sl_prop, dt, banded)
        area = self._area_from_u1(state1["u"], prop)
        fl_control = {"area": area, **{k: control[k] for k in control}}
        res.update(self.fluid.res_pure({"q": state1["q"], "p": state1["p"]},
                                       fl_control, fl_prop))
        return res

    def _picard(self, solve, state0, control, prop, dt, params_d, dt_next,
                start=None):
        """The Picard loop of one step from ``start`` (by default the
        initial state); ``solve`` is the solid's step solve
        (:meth:`SolidModel.solve_state1_pure` or a stale one)."""
        sl_state0 = {k: state0[k] for k in ("u", "v", "a")}
        sl_prop, _ = self._split_prop(prop)
        inner = {**params_d, "initial_guess": "given"}
        fp_params = {**FIXEDPOINT_SOLVER_PRM,
                     **{k: params_d[k] for k in ("aitken", "aitken_omega0")
                        if k in params_d}}
        banded = self.solid.use_banded(params_d)
        counts = self.picard_counts

        def picard(x):
            uva1, info = solve(sl_state0, {"p1": self._pressure_to_solid(x["p"])},
                               sl_prop, dt, inner, dt_next, guess=x)
            counts["iterations"] += 1
            counts["newton_iterations"] = counts["newton_iterations"] + info.num_iter
            return self._fluid_step(uva1, x, control, prop)

        def res_fn(x):
            return self.res_pure(x, state0, control, prop, dt, banded)

        counts["steps"] += 1
        return iterative_solve(dict(state0 if start is None else start), res_fn,
                               picard, fp_params)

    # -- pure step functions ------------------------------------------------------
    def step_pure(self, state0, control, prop, dt, params=None, dt_next=None,
                  guess=None):
        """One Picard-coupled step, each solid solve re-assembling its
        Jacobian (``dt_next`` as in :meth:`ExplicitFSIModel.step_pure`),
        from the first iterate ``guess`` (by default ``state0``)."""
        return self._picard(self.solid.solve_state1_pure, state0, control, prop,
                            dt, solver_params(params), dt_next, guess)

    def step_pure_stale(self, factors, state0, control, prop, dt, params=None,
                        dt_next=None):
        """One Picard-coupled step whose solid solves reuse carried factors."""

        def solve(*args, **kwargs):
            return self.solid.solve_state1_stale(factors, *args, **kwargs)

        return self._picard(solve, state0, control, prop, dt,
                            solver_params(params), dt_next)

    # -- the gradient path ---------------------------------------------------------
    def step_diff(self, state0, control, prop, dt, row, params=None,
                  factors=None):
        """One Picard step as a differentiable function of the state,
        control, properties and the step's coefficient row
        (:class:`_ImplicitStep`); its values are :meth:`step_pure`'s /
        :meth:`step_pure_stale`'s bit for bit."""
        layout, flat = _flatten(state0, control, prop)
        out = _ImplicitStep.apply(self, solver_params(params), dt, layout,
                                  factors, row, *flat)
        n = len(self.state0)
        return dict(zip(self.state0, out[:n])), SolveInfo(*out[n:])

    def _coupled_jac(self, x, state0, control, prop, dt, banded):
        """The dense Jacobian of :meth:`res_pure` in the state at ``x``, over
        the state flattened in sorted key order (a, p, q, u, v, the JAX
        package's ``ravel_pytree``), by a vmapped jvp over chunks of
        ``COUPLED_JAC_CHUNK`` basis vectors."""
        keys = sorted(x)
        sizes = [x[k].numel() for k in keys]
        x_flat = torch.cat([x[k] for k in keys])

        def r_flat(xf):
            r = self.res_pure(dict(zip(keys, torch.split(xf, sizes))), state0,
                              control, prop, dt, banded)
            return torch.cat([r[k] for k in keys])

        def column(t):
            return jvp(r_flat, (x_flat,), (t,))[1]

        eye = torch.eye(x_flat.numel(), dtype=x_flat.dtype, device=x_flat.device)
        cols = [vmap(column)(chunk) for chunk in eye.split(COUPLED_JAC_CHUNK)]
        return torch.cat(cols).mT, keys, sizes

    def _saved(self, ctx):
        """A step's saved tensors: the state x (a dict), the coefficient
        row and the flat inputs."""
        n = len(self.state0)
        saved = ctx.saved_tensors
        x = dict(zip(self.state0, saved[:n]))
        row, flat = saved[n], saved[n + 1:]
        return x, row, flat

    def _ift_vjp(self, ctx, x_bar, needs):
        """The coupled IFT rule: ``J^T lam = x_bar`` with the dense coupled
        Jacobian ``J`` at the converged state (``linalg.
        dense_solve_transpose``), then ``-(dR/dtheta)^T lam`` for the row
        and each flat input that ``needs`` a gradient, by a reverse pass
        over :meth:`res_pure`."""
        if all(g is None for g in x_bar) or not any(needs):
            return (None,) * len(needs)
        x, row, flat = self._saved(ctx)
        banded = self.solid.use_banded(ctx.params_d)
        state0, control, prop = _unflatten(ctx.layout, flat)
        J, keys, sizes = self._coupled_jac(x, state0, control, prop,
                                           StepCoefs(row, self.dtype), banded)
        bar = {k: torch.zeros_like(x[k]) if g is None else g
               for k, g in zip(self.state0, x_bar)}
        lam = linalg.dense_solve_transpose(J, torch.cat([bar[k] for k in keys]))
        lam = dict(zip(keys, torch.split(lam, sizes)))
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(w))
                      for t, w in zip((row, *flat), needs)]
            state0, control, prop = _unflatten(ctx.layout, leaves[1:])
            r = self.res_pure(x, state0, control, prop,
                              StepCoefs(leaves[0], self.dtype), banded)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad([r[k] for k in keys], wanted,
                                             [-lam[k] for k in keys],
                                             allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)

    def _ift_jvp(self, ctx, tangents):
        """The coupled tangent rule (the JAX package's ``step_ift_f``
        custom JVP): ``R_dot`` by a jvp of :meth:`res_pure` at the converged
        state in the row and the flat inputs, then ``x_dot = -J^{-1} R_dot``
        (``linalg.dense_solve``)."""
        x, row, flat = self._saved(ctx)
        banded = self.solid.use_banded(ctx.params_d)
        layout = ctx.layout
        state0, control, prop = _unflatten(layout, flat)
        J, keys, sizes = self._coupled_jac(x, state0, control, prop,
                                           StepCoefs(row, self.dtype), banded)

        def res(row_, *flat_):
            s0, c, p = _unflatten(layout, flat_)
            r = self.res_pure(x, s0, c, p, StepCoefs(row_, self.dtype), banded)
            return torch.cat([r[k] for k in keys])

        primals = (row, *flat)
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents))
        _, r_dot = jvp(res, primals, tangents)
        dx = dict(zip(keys, torch.split(-linalg.dense_solve(J, r_dot), sizes)))
        return tuple(dx[k] for k in self.state0)
