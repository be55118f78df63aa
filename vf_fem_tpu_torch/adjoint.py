"""
Gradients of trajectory functionals (counterpart of ``vf_fem_tpu.adjoint``).

The JAX package differentiates its scanned forward loop with ``jax.grad``;
each Newton solve carries a ``custom_vjp`` implementing the
implicit-function-theorem transposed solve.  Here the forward loop is
recorded by autograd (``forward.integrate_pure`` on inputs that require
grad), each step's Newton solve is a ``torch.autograd.Function`` with the
same IFT rule (``models.transient._SolveU1``: the refined stale-factor
adjoint by default, the transposed block-Thomas solve through kernel K6T
at large meshes), and K5's Newmark update carries its backward kernel
K5T.  Gradients are taken with respect to the initial
state, controls, properties and the time vector at once.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .convert import to_numpy
from .forward import _stack_controls, integrate_pure


def _leaves(d: dict, device, dtype) -> dict:
    """Fresh leaf tensors that require grad, one for each entry of ``d``."""
    out = {}
    for k, v in d.items():
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        out[k] = t.to(device=device, dtype=dtype).requires_grad_()
    return out


def integrate_grad(
    model,
    functional: Callable,
    ini_state: dict,
    controls: list,
    prop: dict,
    times,
    params: Optional[dict] = None,
):
    """Return ``(value, grads)`` of a scalar trajectory functional.

    ``functional(traj, controls_stacked, prop, times)`` maps the stacked
    state trajectory (leading time axis, *excluding* the initial state) to
    a scalar tensor; a functional with ``eval_traj``
    (:class:`~vf_fem_tpu_torch.functional.base.AbstractFunctional`) gets
    the statefile's convention instead: the trajectory with the initial
    state row and a control row at each time.  ``grads`` holds dicts of
    numpy arrays under ``"ini_state"``, ``"controls"`` (stacked, one row a
    control), ``"prop"`` and the numpy gradient with respect to
    ``"times"``, the JAX package's keys.  The value is the no-grad
    forward's bit for bit (the same steps on the same device)."""
    dev, dtype = model.device, model.dtype
    state0 = _leaves(ini_state, dev, dtype)
    controls_stacked = _leaves(_stack_controls(model, controls), dev, dtype)
    prop_d = _leaves(prop, dev, dtype)
    times_t = torch.as_tensor(np.asarray(times, dtype=np.float64)).to(dev)
    times_t.requires_grad_()
    T = times_t.shape[0]

    fin, traj, infos = integrate_pure(model, state0, controls_stacked, prop_d,
                                      times_t, params, use_remat=True)
    if hasattr(functional, "eval_traj"):
        full = {k: torch.cat([state0[k][None], traj[k]], 0) for k in traj}
        n_c = next(iter(controls_stacked.values())).shape[0]
        idx = torch.clamp(torch.arange(T, device=dev), max=n_c - 1)
        cs_full = {k: v[idx] for k, v in controls_stacked.items()}
        value = functional.eval_traj(full, times_t, cs_full, prop_d)
    else:
        value = functional(traj, controls_stacked, prop_d, times_t)

    groups = (state0, controls_stacked, prop_d)
    leaves = [t for g in groups for t in g.values()] + [times_t]
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    it = iter(grads)
    out = [to_numpy({k: next(it) for k in g}) for g in groups]
    return float(value.detach()), {
        "ini_state": out[0],
        "controls": out[1],
        "prop": out[2],
        "times": next(it).detach().cpu().numpy(),
    }


def integrate(model, f, functional, params: Optional[dict] = None):
    """The adjoint entry point on a statefile (``vf_fem_tpu.adjoint.
    integrate``): replays the forward problem from the inputs stored in
    ``f`` (a :class:`~vf_fem_tpu_torch.statefile.StateFile`: initial state,
    control schedule, properties, times) and returns ``(value, grads)`` as
    :func:`integrate_grad` does."""
    ini_state = f.get_state(0)
    prop = f.get_prop()
    times = np.asarray(f.get_times())
    ctrl_keys = list(model.control.keys())
    n_rows = f.root_group["control"][ctrl_keys[0]].shape[0]
    controls = [f.get_control(n) for n in range(min(n_rows, f.size))]
    return integrate_grad(model, functional, ini_state, controls, prop, times,
                          params)
