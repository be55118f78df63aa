"""
Driver-script utilities (counterpart of ``vf_fem_tpu.utils``; reference:
``src/femvf/utils.py``).

:func:`line_search` integrates the model at ``x + h dx`` for each step size
``h``, one run after another on the model's device
(``forward.integrate_pure``), and writes each run to its own group of one
HDF5 file in the reference's layout.  Vectors are dicts of numpy arrays
or tensors (or the JAX package's BlockVectors).
"""

from __future__ import annotations

import os
from os import path
from typing import Sequence

import numpy as np

from .. import statefile as sf
from ..convert import as_dict, to_numpy
from ..forward import _stack_controls, integrate_pure


def _vec(v) -> dict:
    return to_numpy(as_dict(v))


def line_search(
    hs: Sequence[float],
    model,
    ini_state,
    controls,
    prop,
    times,
    dstate,
    dcontrols,
    dprop,
    dtimes,
    filepath: str = "temp.h5",
):
    """Integrate the model at ``x + h * dx`` for every step size in ``hs``
    (``forward.integrate_pure`` with the default solver parameters).

    Run ``n`` is stored under group ``f'{n}'`` of ``filepath``: its
    initial state, the first control as given, the initial time and
    properties, then the trajectory.  Returns ``filepath``."""
    if path.exists(filepath):
        os.remove(filepath)

    hs = np.asarray(list(hs), dtype=float)
    times = np.asarray(times, dtype=float)
    dtimes = np.asarray(dtimes, dtype=float)
    state0, dstate0 = _vec(ini_state), _vec(dstate)
    controls = [_vec(c) for c in controls]
    cs = _stack_controls(model, controls)
    dcs = _stack_controls(model, [_vec(c) for c in dcontrols])
    dcs = {k: np.broadcast_to(v, cs[k].shape) for k, v in dcs.items()}
    prop_d, dprop_d = _vec(prop), _vec(dprop)
    n_steps = len(times) - 1
    idx = np.minimum(np.arange(n_steps), next(iter(cs.values())).shape[0] - 1)

    def shifted(x, dx, h):
        return {k: x[k] + h * dx[k] for k in x}

    for n, h in enumerate(hs):
        s0, c, p = shifted(state0, dstate0, h), shifted(cs, dcs, h), shifted(prop_d, dprop_d, h)
        t = times + h * dtimes
        _, traj, infos = integrate_pure(model, s0, c, p, t)
        with sf.StateFile(model, filepath, group=f"{n}", mode="a") as f:
            f.init_layout()
            f.append_state(s0)
            f.append_control(controls[0])
            f.append_time(t[0])
            f.append_solver_info({"num_iter": 0, "abs_err": 0, "rel_err": 0})
            f.append_prop(p)
            f.append_window(traj, {k: v[idx] for k, v in c.items()}, t[1:],
                            to_numpy(infos._asdict()))
    return filepath


def functional_on_line_search(hs, functional, model, filepath):
    """``functional`` on every stored run of a :func:`line_search` /
    :func:`line_search_p` file (run ``n`` under group ``f'{n}'``):
    ``np.array([functional(f_0), functional(f_1), ...])``."""
    values = []
    for n, _h in enumerate(hs):
        with sf.StateFile(model, filepath, group=f"{n}", mode="r") as f:
            values.append(functional(f))
    return np.array(values)


def line_search_p(
    hs, model, p, dp, ini_state=None, controls=None, times=None,
    filepath: str = "temp.h5",
):
    """A line search over the properties only, from rest by default."""
    zero_state = {k: np.zeros_like(v) for k, v in model.state0.items()}
    controls = controls or [model.control]
    dcontrols = [{k: np.zeros_like(np.asarray(v)) for k, v in _vec(c).items()}
                 for c in controls]
    return line_search(
        hs, model, ini_state if ini_state is not None else zero_state, controls, p,
        times, zero_state, dcontrols, dp, np.zeros_like(np.asarray(times)),
        filepath=filepath,
    )
