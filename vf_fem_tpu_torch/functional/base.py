"""
Trajectory functionals (counterpart of ``vf_fem_tpu.functional.base``).

Every functional is one pure function ``eval_traj(traj, times, controls,
props)`` of the full stored trajectory (dicts of (T, n) tensors; ``times``
float64); every derivative, the algebra's included, is
``torch.autograd.grad`` of it.  Values are cached per statefile.
"""

from __future__ import annotations

import copy
import operator

import numpy as np
import torch


def _load_statefile(model, f):
    """The full stored trajectory of a statefile as numpy arrays:
    ``(traj, times, controls, props)``."""
    traj = {k: np.asarray(v) for k, v in f.get_state_trajectory().items()}
    times = np.asarray(f.get_times())
    controls = {k: np.asarray(v) for k, v in f.get_control_trajectory().items()}
    try:
        props = {k: np.asarray(v) for k, v in f.get_prop().items()}
    except KeyError:
        props = {k: np.asarray(v) for k, v in model.prop.items()}
    return traj, times, controls, props


class AbstractFunctional:
    """A scalar ``eval_traj(traj, times, controls, props)`` of a stored
    run, with the functional algebra (+, -, *, /, ** with other
    functionals and scalars) and derivatives by autograd."""

    CACHE = True
    default_constants: dict = {}

    def __init__(self, model, *funcs):
        self.model = model
        self.funcs = tuple(funcs)
        self.constants = copy.deepcopy(type(self).default_constants)
        self.cache: dict = {}
        self._value = None
        self._f = None

    # -- to be implemented by subclasses --------------------------------------
    def eval_traj(self, traj, times, controls, props):
        raise NotImplementedError

    # -- evaluation over a statefile ------------------------------------------
    def _tensors(self, f, requires_grad=False):
        """The statefile's run as tensors on the model's device (states,
        controls and properties in the model's dtype, times in float64)."""
        traj, times, controls, props = _load_statefile(self.model, f)
        dev, dtype = self.model.device, self.model.dtype

        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=dev).requires_grad_(requires_grad)

        return ({k: t(v) for k, v in traj.items()}, t(times, torch.float64),
                {k: t(v) for k, v in controls.items()},
                {k: t(v) for k, v in props.items()})

    def __call__(self, f):
        if self._f is not f or self._value is None or not self.CACHE:
            self._value = self.eval(f)
            self._f = f
            self.cache.clear()
        return self._value

    def eval(self, f) -> float:
        with torch.no_grad():
            return float(self.eval_traj(*self._tensors(f)))

    # -- derivatives ------------------------------------------------------------
    def _grads(self, f):
        key = ("grads", id(f))
        if key not in self.cache:
            args = self._tensors(f, requires_grad=True)
            groups = (args[0], {"t": args[1]}, args[2], args[3])
            leaves = [v for g in groups for v in g.values()]
            grads = torch.autograd.grad(self.eval_traj(*args), leaves,
                                        allow_unused=True)
            it = iter(np.zeros(tuple(v.shape)) if g is None else g.cpu().numpy()
                      for v, g in zip(leaves, grads))
            g_traj, g_t, g_controls, g_props = (
                {k: next(it) for k in g} for g in groups)
            self.cache[key] = (g_traj, g_t["t"], g_controls, g_props)
        return self.cache[key]

    def eval_dstate(self, f, n: int) -> dict:
        """dJ/d(state at stored index n)."""
        g_traj = self._grads(f)[0]
        return {k: g_traj[k][n] for k in self.model.state0}

    def dstate(self, f, n):
        return self.eval_dstate(f, n)

    def eval_dprops(self, f) -> dict:
        g_props = self._grads(f)[3]
        return {k: g_props[k] for k in self.model.prop}

    def dprop(self, f):
        return self.eval_dprops(f)

    def eval_dtimes(self, f) -> np.ndarray:
        return self._grads(f)[1]

    def eval_ddt(self, f, n: int) -> float:
        """dJ/d(dt_n) with dt_n = t_n - t_{n-1}: since t_m = t_0 + sum dt,
        dJ/ddt_n = sum_{m >= n} dJ/dt_m."""
        return float(np.sum(self.eval_dtimes(f)[n:]))

    def ddt(self, f, n):
        return self.eval_ddt(f, n)

    def eval_dt0(self, f, n=None) -> float:
        return float(np.sum(self.eval_dtimes(f)))

    def dt0(self, f, n=None):
        return self.eval_dt0(f)

    # -- algebra ----------------------------------------------------------------
    def _combine(self, other, op, name):
        return _BinaryFunctional(self.model, self, other, op, name)

    def __add__(self, other):
        return self._combine(other, operator.add, "sum")

    def __radd__(self, other):
        return self._combine(other, operator.add, "sum")

    def __sub__(self, other):
        return self._combine(other, operator.sub, "diff")

    def __rsub__(self, other):
        return _BinaryFunctional(self.model, other, self, operator.sub, "diff")

    def __mul__(self, other):
        return self._combine(other, operator.mul, "product")

    def __rmul__(self, other):
        return self._combine(other, operator.mul, "product")

    def __truediv__(self, other):
        return self._combine(other, operator.truediv, "quotient")

    def __pow__(self, other):
        return self._combine(other, operator.pow, "power")


class _BinaryFunctional(AbstractFunctional):
    """A composed functional (sum, difference, product, quotient, power)."""

    def __init__(self, model, a, b, op, name):
        super().__init__(model)
        self._a, self._b, self._op = a, b, op
        self._name = name

    def _term(self, term, traj, times, controls, props):
        if isinstance(term, AbstractFunctional):
            return term.eval_traj(traj, times, controls, props)
        return term  # a scalar constant

    def eval_traj(self, traj, times, controls, props):
        return self._op(
            self._term(self._a, traj, times, controls, props),
            self._term(self._b, traj, times, controls, props),
        )


class Scalar(AbstractFunctional):
    """A constant functional."""

    def __init__(self, model, value):
        super().__init__(model)
        self._const = float(value)

    def eval_traj(self, traj, times, controls, props):
        return torch.tensor(self._const, dtype=torch.float64, device=times.device)
