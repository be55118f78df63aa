"""
Forward time integration (counterpart of ``vf_fem_tpu.forward``).

The JAX package runs the time loop as one ``lax.scan``; here it is a
Python loop over steps on the model's device.  In fixed-iteration Newton
mode a step issues no host synchronisation, so the device queue stays
full; the adaptive mode reads each iteration's residual norm on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .convert import to_tensors
from .models.transient import solver_params
from .solvers.newton import SolveInfo


def integrate_pure(
    model,
    ini_state: dict,
    controls_stacked: dict,
    prop: dict,
    times,
    params: Optional[dict] = None,
):
    """Integrate from ``ini_state`` over ``times``.

    ``controls_stacked`` holds each control key with a leading axis of
    control steps (the last one is held); inputs may be numpy arrays or
    tensors and are moved to the model's device and dtype.  Returns
    ``(fin_state, trajectory, infos)``; trajectory and info tensors have a
    leading time axis of length ``len(times) - 1``.

    With ``jacobian_refresh_steps=K > 1`` the Jacobian factors are built
    once per window of K steps and carried through the window's steps.
    ``jacobian_refresh_mode='ns'`` keeps the initial factors for window 0,
    refactors fully in every window ``w`` with ``w % full_every == 0``
    (``full_every = jacobian_full_refresh_windows``) and otherwise applies
    a Newton-Schulz refresh; a trailing partial window refreshes by the
    same rule.  'full' mode refactors in every window.
    """
    params_d = solver_params(params)
    dev, dtype = model.device, model.dtype
    state = to_tensors(ini_state, dev, dtype)
    controls = to_tensors(controls_stacked, dev, dtype)
    prop = to_tensors(prop, dev, dtype)
    dts = [float(x) for x in np.diff(np.asarray(times, dtype=np.float64))]
    n_steps = len(dts)
    n_controls = next(iter(controls.values())).shape[0]

    def control_at(n):
        i = min(n, n_controls - 1)
        return {k: v[i] for k, v in controls.items()}

    traj, infos = [], []

    def run(state, factors, n0, n1):
        for n in range(n0, n1):
            if factors is None:
                state, info = model.step_pure(
                    state, control_at(n), prop, dts[n], params_d
                )
            else:
                state, info = model.step_pure_stale(
                    factors, state, control_at(n), prop, dts[n], params_d
                )
            traj.append(state)
            infos.append(info)
        return state

    def factorize(state, n0):
        return model.factorize(state, control_at(n0), prop, dts[n0], params_d)

    def refresh(factors, state, n0):
        return model.refresh_factors(
            factors, state, control_at(n0), prop, dts[n0], params_d
        )

    refresh_k = int(params_d.get("jacobian_refresh_steps", 1))
    with torch.no_grad():
        if refresh_k <= 1:
            state = run(state, None, 0, n_steps)
        else:
            use_ns = params_d.get("jacobian_refresh_mode", "full") == "ns"
            full_every = int(params_d.get("jacobian_full_refresh_windows", 8))
            n_win, rem = divmod(n_steps, refresh_k)
            factors = None
            for w in range(n_win):
                n0 = w * refresh_k
                # window 0 factors the initial state in both modes
                if not use_ns or w % full_every == 0:
                    factors = factorize(state, n0)
                else:
                    factors = refresh(factors, state, n0)
                state = run(state, factors, n0, n0 + refresh_k)
            if rem:
                n0 = n_win * refresh_k
                if use_ns and n_win and n_win % full_every:
                    factors = refresh(factors, state, n0)
                else:
                    factors = factorize(state, n0)
                state = run(state, factors, n0, n_steps)

    if not traj:
        raise ValueError("integrate_pure needs at least two time points")
    trajectory = {k: torch.stack([s[k] for s in traj]) for k in traj[0]}
    info = SolveInfo(*(torch.stack(x) for x in zip(*infos)))
    return state, trajectory, info
