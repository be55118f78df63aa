"""
Parameter transforms (counterpart of ``vf_fem_tpu.parameters.transform``;
reference: ``src/femvf/parameters/transform.py``).

A :class:`Transform` maps an input parameter vector to a model property
vector, with ``apply_jvp``/``apply_vjp`` linearizations and ``*``
composition (``t1 * t2`` applies t1 then t2).  Vectors are dicts of numpy
arrays where the JAX package takes BlockVectors: ``transform.x`` and
``transform.y`` are prototypes (copies), and every method takes and
returns such dicts (inputs may also be tensors).

:class:`FunctionTransform` is defined by one torch function and takes both
linearizations from it (``torch.func.jvp``/``vjp``); :class:`TractionShape`
solves the auxiliary linear-elastic problem ``K umesh = T t``, dense on
small meshes on the CPU and block-banded on the model's device otherwise (the
fill ``solvers.bsb.bsb_fill``, the f64 block-Thomas factors
``solvers.btd.btd_factor``, solves by kernel K6 and K6T, ``T t`` and
``T^T lam`` through the banded residual, kernels K1 and K2).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd, jvp, vjp, vmap

from ..fem import assembly
from ..fem import forms as F
from ..fem.continuum import strain_inf
from ..residuals.base import FemResidual
from ..solvers import bsb as bsb_mod
from ..solvers import btd as btd_mod

__all__ = [
    "Transform",
    "TransformComposition",
    "FunctionTransform",
    "TransformFromModel",
    "Identity",
    "Scale",
    "ConstantSubset",
    "ExtractSubset",
    "LayerModuli",
    "TractionShape",
]


def _array(v) -> np.ndarray:
    """An array or tensor as a new float64 numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=float)


def _copy(d: dict) -> dict:
    return {k: _array(v) for k, v in d.items()}


def _zeros(d: dict) -> dict:
    return {k: np.zeros_like(v) for k, v in _copy(d).items()}


class Transform:
    """A map from ``x`` (the input prototype) to ``y`` (the output
    prototype), with its linearizations (reference: ``transform.py:30-113``)."""

    _x: dict
    _y: dict

    @property
    def x(self) -> dict:
        return _copy(self._x)

    @property
    def y(self) -> dict:
        return _copy(self._y)

    def apply(self, x: dict) -> dict:
        raise NotImplementedError()

    def apply_vjp(self, x: dict, hy: dict) -> dict:
        raise NotImplementedError()

    def apply_jvp(self, x: dict, dx: dict) -> dict:
        raise NotImplementedError()

    def __mul__(self, other):
        return TransformComposition(self, other)

    def __rmul__(self, other):
        return TransformComposition(other, self)


class TransformComposition(Transform):
    """``t1 * t2``: apply t1 then t2 (reference: ``transform.py:118-166``)."""

    def __init__(self, transform_1: Transform, transform_2: Transform):
        self._transforms = (transform_1, transform_2)
        self._x = transform_1.x
        self._y = transform_2.y

    def apply(self, x):
        t1, t2 = self._transforms
        return t2.apply(t1.apply(x))

    def apply_vjp(self, x, hy):
        t1, t2 = self._transforms
        return t1.apply_vjp(x, t2.apply_vjp(t1.apply(x), hy))

    def apply_jvp(self, x, dx):
        t1, t2 = self._transforms
        return t2.apply_jvp(t1.apply(x), t1.apply_jvp(x, dx))


class FunctionTransform(Transform):
    """A transform defined by one torch function ``fn(x_dict) -> y_dict``
    of float64 CPU tensors, whose linearizations are ``torch.func.jvp`` and
    ``torch.func.vjp`` of it.  It stands in for the JAX package's
    ``JaxTransform`` (one pure ``jax.numpy`` function, linearized by
    ``jax.jvp``/``jax.vjp``; reference ``transform.py:340-415``)."""

    def __init__(self, x_proto: dict, y_proto: dict, fn: Callable):
        self._x = _copy(x_proto)
        self._y = _copy(y_proto)
        self._fn = fn

    @staticmethod
    def _tensors(d: dict, keys) -> dict:
        return {k: torch.as_tensor(_array(d[k])) for k in keys}

    def _out(self, y: dict) -> dict:
        return {k: y[k].detach().numpy().copy() for k in self._y}

    def apply(self, x):
        return self._out(self._fn(self._tensors(x, self._x)))

    def apply_jvp(self, x, dx):
        _, dy = jvp(self._fn, (self._tensors(x, self._x),), (self._tensors(dx, self._x),))
        return self._out(dy)

    def apply_vjp(self, x, hy):
        y, pullback = vjp(self._fn, self._tensors(x, self._x))
        (hx,) = pullback({k: torch.as_tensor(_array(hy[k])) if k in hy else torch.zeros_like(v)
                          for k, v in y.items()})
        return {k: hx[k].detach().numpy().copy() for k in self._x}


class TransformFromModel(Transform):
    """Output space = ``model.prop`` (reference: ``transform.py:169-184``)."""

    def __init__(self, model):
        self.model = model
        self._y = _zeros(model.prop)


class Identity(FunctionTransform):
    """y = x over model.prop (reference: ``transform.py:474-483``)."""

    def __init__(self, model):
        super().__init__(model.prop, model.prop, lambda x: dict(x))
        self.model = model


class Scale(FunctionTransform):
    """y[key] = scale[key] * x[key] (reference: ``transform.py:515-553``)."""

    def __init__(self, model, scale: Optional[dict] = None):
        scale = dict(scale or {})

        def fn(x):
            return {k: x[k] * scale.get(k, 1.0) for k in x}

        super().__init__(model.prop, model.prop, fn)
        self.model = model
        self.scale = scale


class ConstantSubset(FunctionTransform):
    """Hold a subset of keys at constant values, pass the rest through
    (reference: ``transform.py:486-512``)."""

    def __init__(self, model, const_vals: Optional[dict] = None):
        const_vals = dict(const_vals or {})

        def fn(x):
            return {k: (torch.full_like(v, float(const_vals[k])) if k in const_vals
                        else v) for k, v in x.items()}

        super().__init__(model.prop, model.prop, fn)
        self.model = model


class ExtractSubset(Transform):
    """Input = a subset of prop keys; other outputs take the model's values
    (reference: ``transform.py:556-583``)."""

    def __init__(self, model, keys):
        self.model = model
        self._keys = list(keys)
        prop = _copy(model.prop)
        self._x = {k: prop[k] for k in self._keys}
        self._y = prop

    def apply(self, x):
        y = self.y
        for k in self._keys:
            y[k] = _array(x[k])
        return y

    def apply_jvp(self, x, dx):
        dy = _zeros(self._y)
        for k in self._keys:
            dy[k] = _array(dx[k])
        return dy

    def apply_vjp(self, x, hy):
        return {k: _array(hy[k]) for k in self._keys}


class LayerModuli(Transform):
    """One stiffness value per named cell layer -> the DG0 emod field
    (reference: ``transform.py:419-454``)."""

    def __init__(self, model):
        self.model = model
        solid = getattr(model, "solid", model)
        mesh = solid.residual.mesh()
        subdomains = mesh.subdomains[mesh.dim]
        if not subdomains:
            raise ValueError("Mesh has no named cell subdomains")
        self._layers = list(subdomains)
        markers = mesh.mesh_functions[mesh.dim]
        self._masks = {name: (markers == val).astype(float)
                       for name, val in subdomains.items()}
        self._x = {name: np.zeros(1) for name in self._layers}
        self._y = _copy(model.prop)

    def _field(self, x) -> np.ndarray:
        return sum(float(_array(x[name]).reshape(-1)[0]) * self._masks[name]
                   for name in self._layers)

    def apply(self, x):
        y = _copy(self.model.prop)
        y["emod"] = self._field(x)
        return y

    def apply_jvp(self, x, dx):
        dy = _zeros(self.model.prop)
        dy["emod"] = self._field(dx)
        return dy

    def apply_vjp(self, x, hy):
        h_emod = _array(hy["emod"])
        return {name: np.array([np.dot(self._masks[name], h_emod)])
                for name in self._layers}


class _LameElasticForm(F.BaseForm):
    """Auxiliary linear-elastic form parameterized directly by the Lame
    constants (the residual of :class:`TractionShape`)."""

    COEFFICIENT_SPEC = {
        "state/u1": F.cg1_vector(),
        "prop/lame_lambda": F.const_scalar(1.0),
        "prop/lame_mu": F.const_scalar(1.0),
    }

    def cell_kernel(self, geom, local):
        eps = strain_inf(F.grad_field(local["state/u1"], geom.grads))
        lam = local["prop/lame_lambda"]
        mu = local["prop/lame_mu"]
        tr = eps[..., 0, 0] + eps[..., 1, 1] + eps[..., 2, 2]
        eye = torch.eye(3, dtype=eps.dtype, device=eps.device)
        sig = 2 * mu * eps + (lam * tr)[..., None, None] * eye
        return F._stress_residual(sig, geom)


def _pick_solver(solver: str, device, ndof: int, dense_max_dofs: int) -> str:
    """:class:`TractionShape`'s solve path: 'dense' solves on the host, so
    only a model on the CPU may take it."""
    on_cpu = torch.device(device).type == "cpu"
    if solver == "auto":
        return "dense" if on_cpu and ndof <= dense_max_dofs else "banded"
    if solver not in ("dense", "banded"):
        raise ValueError(f"unknown TractionShape solver {solver!r}")
    if solver == "dense" and not on_cpu:
        raise ValueError(
            "TractionShape: solver='dense' solves on the host; a model on"
            f" {device} takes solver='banded' (or 'auto')")
    return solver


class TractionShape(TransformFromModel):
    """Map a surface traction to a mesh displacement by solving an
    auxiliary linear-elastic problem (reference: ``transform.py:187-333``):
    ``umesh = K^{-1} T t``, K the Lame stiffness (Dirichlet rows on the
    'fixed' boundary) and T the surface-traction load operator; the vjp is
    the transposed solve.

    ``solver``: ``'banded'`` (best on an RCM-numbered mesh,
    ``reorder='rcm'``) runs on the model's device in float64: K is filled
    by ``bsb_fill`` from the element stiffness blocks at u1 = 0 and
    factored once by ``btd_factor``; ``apply`` is ``btd_solve`` (kernel K6)
    of ``T t``, ``apply_vjp`` is ``T^T btd_solve_t(h)`` (kernel K6T), and
    ``T t`` / ``T^T lam`` are the forward- and reverse-mode derivatives of
    the banded traction residual (kernels K1 and K2).  The JAX package runs
    this path on the host CPU; here it stays on the device.  ``'dense'``
    builds K and T as dense matrices (``FemResidual.assemble_jac_dense``)
    and solves them with numpy, so it is only for a model on the CPU; on
    another device it raises.  ``'auto'`` (default) picks banded on a
    device other than the CPU, and on the CPU dense up to
    ``dense_max_dofs`` dofs, banded above."""

    def __init__(self, model, lame_lambda=1.0, lame_mu=1.0,
                 dirichlet_bcs=None, solver: str = "auto",
                 dense_max_dofs: int = 6000):
        super().__init__(model)
        solid = getattr(model, "solid", model)
        mesh = solid.residual.mesh()
        self._solid = solid
        self.device = solid.device
        aux = FemResidual(
            [(1.0, _LameElasticForm()), (-1.0, F.ManualSurfaceContactTractionForm())],
            mesh, traction_subdomains=solid.residual._traction_subdomains,
            dirichlet_bc_specs=dirichlet_bcs, device=self.device,
            dtype=torch.float64,
        )
        fields = {k: torch.as_tensor(v, dtype=torch.float64, device=self.device)
                  for k, v in aux.default_coefficients().items()}
        fields["prop/lame_lambda"] = fields["prop/lame_lambda"].new_tensor([float(lame_lambda)])
        fields["prop/lame_mu"] = fields["prop/lame_mu"].new_tensor([float(lame_mu)])
        self._aux, self._fields = aux, fields
        ndof = solid.ndof
        self._x = {"tmesh": np.zeros(ndof)}
        self._solver = solver = _pick_solver(solver, self.device, ndof, dense_max_dofs)
        bc = aux.bc_dofs
        mask = np.ones(ndof)
        mask[bc] = 0.0
        self._bc_mask = torch.as_tensor(mask, device=self.device)
        if solver == "banded":
            cell_dofs = assembly.cell_dof_array(mesh.cells, mesh.dim)
            # the traction form carries no d/du1: K is the cells' Lame blocks
            self._plan = bsb_mod.plan_bsb([cell_dofs], ndof, bc)
            self._fill = bsb_mod.fill_plan(self._plan, self.device)
            self._factors = btd_mod.btd_factor(self._plan, self.assemble_K_blocks())
            return
        K = aux.assemble_jac_dense(fields, "state/u1").cpu().numpy()
        T = aux.assemble_jac_dense(fields, "control/tcontact").cpu().numpy()
        K[bc, :] = 0.0
        K[bc, bc] = 1.0
        T[bc, :] = 0.0
        self._K, self._T = K, T

    # -- the banded path ---------------------------------------------------
    def assemble_K_blocks(self) -> torch.Tensor:
        """The block-banded K (``solvers.bsb`` layout) on the device: the
        element stiffness at u1 = 0 by ``vmap(jacfwd)``, filled by
        ``bsb_fill``.  Rebuilt on demand (for the certificate ``K umesh =
        T t``): only the factors are kept."""
        aux, mesh = self._aux, self._aux.mesh()
        cells = aux.topology.cells
        local, axes = aux.gather_cell_locals(self._fields)
        cell_elem = aux.cell_elem_fn()

        def cell_fn(u1_e, Xe, loc):
            return cell_elem(Xe, {**loc, "state/u1": u1_e})

        nv = cells.shape[1]
        Jc = vmap(jacfwd(cell_fn), in_dims=(0, 0, axes))(
            torch.zeros((cells.shape[0], nv, mesh.dim), dtype=torch.float64,
                        device=self.device),
            aux.X_ref[cells], local,
        ).reshape(-1, nv * mesh.dim, nv * mesh.dim)
        return bsb_mod.bsb_fill(self._plan, self._fill, [Jc])

    def _res_of_t(self, t: torch.Tensor) -> torch.Tensor:
        """The auxiliary residual at u1 = 0 as a function of the traction
        (linear): its cell pass through the banded kernels where the mesh
        admits a plan."""
        aux = self._aux
        nvert, dim = aux.mesh().num_vertices, aux.mesh().dim
        fields = {**self._fields, "control/tcontact": t.reshape(nvert, dim),
                  "state/u1": torch.zeros((nvert, dim), dtype=t.dtype, device=t.device)}
        return aux.assemble_res(fields, banded=aux.banded_ok()).reshape(-1)

    def T_mv(self, t: torch.Tensor) -> torch.Tensor:
        """``T t``: the forward-mode derivative of the traction residual,
        Dirichlet rows zeroed."""
        zero = torch.zeros_like(t)
        return jvp(self._res_of_t, (zero,), (t,))[1] * self._bc_mask

    def T_rmv(self, lam: torch.Tensor) -> torch.Tensor:
        """``T^T lam``: the reverse-mode derivative of the traction residual
        (autograd, so K1 and K2 run as each other's backward)."""
        t = torch.zeros_like(lam).requires_grad_()
        with torch.enable_grad():
            r = self._res_of_t(t)
            (g,) = torch.autograd.grad(r, t, lam * self._bc_mask)
        return g

    def _vector(self, v) -> torch.Tensor:
        t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return t.reshape(-1).to(device=self.device, dtype=torch.float64)

    def _solve_fwd(self, t) -> np.ndarray:
        if self._solver == "banded":
            with torch.no_grad():
                u = btd_mod.btd_solve(self._plan, self._factors, self.T_mv(self._vector(t)))
            return u.cpu().numpy()
        return np.linalg.solve(self._K, self._T @ _array(t).reshape(-1))

    def _solve_bwd(self, h) -> np.ndarray:
        if self._solver == "banded":
            with torch.no_grad():
                lam = btd_mod.btd_solve_t(self._plan, self._factors, self._vector(h))
            return self.T_rmv(lam).cpu().numpy()
        return self._T.T @ np.linalg.solve(self._K.T, _array(h).reshape(-1))

    def apply(self, x):
        y = _copy(self.model.prop)
        y["umesh"] = self._solve_fwd(x["tmesh"])
        return y

    def apply_jvp(self, x, dx):
        dy = _zeros(self.model.prop)
        dy["umesh"] = self._solve_fwd(dx["tmesh"])
        return dy

    def apply_vjp(self, x, hy):
        return {"tmesh": self._solve_bwd(hy["umesh"])}
