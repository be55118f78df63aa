"""
Forward time integration (counterpart of ``vf_fem_tpu.forward``).

The JAX package runs the whole time loop as one jitted ``lax.scan``.  Here
:func:`integrate_pure` steps on the model's device in one of two ways, by
the run's configuration:

- a fixed-iteration run on a CUDA model whose steps solve with factors
  carried through refresh windows (``fixed_iterations`` set,
  ``jacobian_refresh_steps > 1``, ``linear_solver`` 'dense', 'btd' or
  'spike') replays one captured CUDA graph a step, cached on the model like the JAX
  package's ``_scan_cache`` (:mod:`.step_graph`); the factorizations
  between windows run eagerly;
- every other run is a Python loop of eager steps: adaptive Newton (the
  default) reads each iteration's residual norm on the host, the Krylov
  solvers 'cg' and 'bsb' read BiCGStab's norms, a run that factors in
  every step syncs in its factorization, and a CPU model has no graphs;
- a run whose initial state, controls, properties or times require grad
  is the differentiable loop :func:`_integrate_diff` (the gradient path of
  ``adjoint``): the same steps and windows, eager, never the graph, with
  autograd recording each step.

:func:`integrate_batch_pure` runs a batch of variants of one model at
once (``parallel.sweep``): the same three loops over a leading batch axis
of the properties (and of the controls, with ``batch_controls``), each
step one batched step of the explicit FSI model (its ``*_batch`` step
functions), so that a step launches each kernel once for the whole batch;
a fixed-iteration run with refresh windows replays one captured graph of
the batched step.

Any transient model with the FSI model's step functions runs here: the
explicit and implicit FSI models, the FSAI model (``models.fsai``, whose
step info adds ``bracketed``) and the WRA tract alone
(``models.acoustic.WRAnalog``: no solid, no factors, always eager,
without refresh windows).

:func:`integrate` adds the HDF5 statefile (:mod:`.statefile`, which needs
h5py; ``f=None`` needs none), the divergence flags and the certification
of fixed-iteration runs; :func:`integrate_extend` resumes from a file and
:func:`integrate_step` takes one step.  :func:`integrate_linear` (on a
statefile's run) and :func:`integrate_linear_pure` propagate tangents
through the differentiable loop in forward mode.  Runs are dicts of numpy
arrays or tensors where the JAX package takes BlockVectors.

Units are CGS.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
from torch.func import jvp

from . import step_graph
from .convert import to_numpy, to_tensors
from .models.transient import solver_params

Options = dict


def _stack_controls(model, controls) -> dict:
    """Stack a list of control dicts into a leading-axis dict, in the
    model's control key order."""
    return {k: np.stack([np.asarray(c[k]) for c in controls], axis=0)
            for k in model.control}


def _wants_grad(*args) -> bool:
    """Whether a run's inputs (dicts of arrays or tensors, and the times)
    hold a tensor that requires grad, with grad mode on."""
    if not torch.is_grad_enabled():
        return False
    for a in args:
        for v in (a.values() if isinstance(a, dict) else (a,)):
            if isinstance(v, torch.Tensor) and v.requires_grad:
                return True
    return False


def integrate_pure(
    model,
    ini_state: dict,
    controls_stacked: dict,
    prop: dict,
    times,
    params: Optional[dict] = None,
    use_remat: bool = False,
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

    A fixed-iteration run of such windows on a CUDA model with a direct
    solver ('dense', 'btd', 'spike') replays one captured CUDA graph a step (see the
    module docstring; a capture that fails raises); its results are the
    eager loop's bit for bit.

    Where an input requires grad the run is differentiable
    (:func:`_integrate_diff`; its values are the eager loop's bit for bit).
    ``use_remat`` is the JAX signature's; nothing is checkpointed here,
    since each step's backward rebuilds its residual anyway.
    """
    params_d = solver_params(params)
    if _wants_grad(ini_state, controls_stacked, prop, times):
        return _integrate_diff(model, ini_state, controls_stacked, prop, times,
                               params_d)
    if step_graph.captures(model, params_d):
        return step_graph.integrate(model, ini_state, controls_stacked, prop,
                                    times, params_d)
    return _integrate_eager(model, ini_state, controls_stacked, prop, times,
                            params_d)


def integrate_batch_pure(
    model,
    ini_state: dict,
    controls_stacked: dict,
    prop_batch: dict,
    times,
    params: Optional[dict] = None,
    batch_controls: bool = False,
):
    """:func:`integrate_pure` of a batch of variants of one explicit FSI
    model at once, the JAX package's ``vmap(integrate_pure)`` over a leading
    batch axis: of every tensor of ``prop_batch``, and with
    ``batch_controls`` of ``controls_stacked`` (each variant's stacked
    controls); ``ini_state`` is every variant's.  Returns ``(fin_state,
    trajectory, infos)`` with the batch axis first: ``(B, ...)``,
    ``(B, n_steps, ...)`` and ``(B, n_steps)`` tensors.

    Each step is one batched step (the model's ``step_batch`` /
    ``step_batch_stale``, dense solver only), by the windows and refresh
    rule of :func:`integrate_pure`: a fixed-iteration run of refresh windows
    on a CUDA model replays one captured graph of the batched step, every
    other run is the eager loop (the adaptive Newton in lockstep, one host
    read a batch iteration), and a run whose properties, controls or
    initial state require grad is the differentiable loop (the batch's
    values, with each variant's gradient its own: the variants share
    nothing but the times).  Row b equals :func:`integrate_pure` of variant
    b alone to the rounding of batched against unbatched products."""
    if not hasattr(model, "step_batch"):
        raise NotImplementedError(f"a batch of {type(model).__name__} variants is not ported")
    params_d = solver_params(params)
    batch = (_batch_size(prop_batch), bool(batch_controls))
    if _wants_grad(ini_state, controls_stacked, prop_batch, times):
        out = _integrate_diff(model, ini_state, controls_stacked, prop_batch, times,
                              params_d, batch)
    elif step_graph.captures(model, params_d):
        out = step_graph.integrate(model, ini_state, controls_stacked, prop_batch, times,
                                   params_d, batch)
    else:
        out = _integrate_eager(model, ini_state, controls_stacked, prop_batch, times,
                               params_d, batch)
    fin, traj, info = out
    return (fin, {k: v.movedim(0, 1) for k, v in traj.items()},
            type(info)(*(x.movedim(0, 1) for x in info)))


def _batch_size(prop_batch: dict) -> int:
    sizes = {int(np.shape(v)[0]) for v in prop_batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"the properties' batch axes differ: {sorted(sizes)}")
    return sizes.pop()


def run_inputs(model, ini_state, controls_stacked, prop, batch=None):
    """A run's initial state, stacked controls and properties as tensors on
    the model's device and dtype.  ``batch``, ``(B, batch_controls)`` of a
    batched run: the state is broadcast to (B, ...) (one copy a variant),
    the controls made (n_controls, B, ...) (a view of shared controls, or
    each variant's moved behind the control axis), the properties kept
    (B, ...)."""
    dev, dtype = model.device, model.dtype
    state = to_tensors(ini_state, dev, dtype)
    controls = to_tensors(controls_stacked, dev, dtype)
    prop = to_tensors(prop, dev, dtype)
    if batch is not None:
        B, batch_controls = batch
        state = {k: v.expand(B, *v.shape).contiguous() for k, v in state.items()}
        controls = {k: (v.movedim(0, 1) if batch_controls
                        else v.unsqueeze(1).expand(v.shape[0], B, *v.shape[1:]))
                    for k, v in controls.items()}
    return state, controls, prop


_STEPPERS = ("step_pure", "step_pure_stale", "factorize", "refresh_factors", "step_diff")


def steppers(model, batch=None):
    """The model's ``(step, step_stale, factorize, refresh_factors,
    step_diff)``, of one variant or (``batch``) of a batch of them (the
    ``*_batch`` methods); each looked up when called, since a model without
    factors (the WRA tract) has only some."""
    names = _STEPPERS if batch is None else (
        "step_batch", "step_batch_stale", "factorize_batch", "refresh_factors_batch",
        "step_diff_batch")

    def method(name):
        return lambda *args: getattr(model, name)(*args)

    return tuple(method(n) for n in names)


def _integrate_eager(model, ini_state, controls_stacked, prop, times,
                     params=None, batch=None):
    """:func:`integrate_pure` as a Python loop of eager steps, whatever the
    configuration (the CUDA graph's reference on the card); ``batch`` as
    :func:`run_inputs`."""
    params_d = solver_params(params)
    state, controls, prop = run_inputs(model, ini_state, controls_stacked, prop, batch)
    step, step_stale, factorize, refresh, _ = steppers(model, batch)
    dts = [float(x) for x in np.diff(np.asarray(times, dtype=np.float64))]
    n_steps = len(dts)
    if not n_steps:
        raise ValueError("integrate_pure needs at least two time points")
    n_controls = next(iter(controls.values())).shape[0]

    def control_at(n):
        i = min(n, n_controls - 1)
        return {k: v[i] for k, v in controls.items()}

    traj, infos = [], []

    def run(state, factors, n0, n1):
        for n in range(n0, n1):
            # the step after this one: the predictor K5 writes with the state
            dt_next = dts[min(n + 1, n_steps - 1)]
            if factors is None:
                state, info = step(state, control_at(n), prop, dts[n], params_d,
                                   dt_next)
            else:
                state, info = step_stale(factors, state, control_at(n), prop, dts[n],
                                         params_d, dt_next)
            traj.append(state)
            infos.append(info)
        return state

    with torch.no_grad():
        if int(params_d.get("jacobian_refresh_steps", 1)) <= 1:
            state = run(state, None, 0, n_steps)
        else:
            factors = None
            for n0, n1, how in step_graph.refresh_windows(n_steps, params_d):
                args = (state, control_at(n0), prop, dts[n0], params_d)
                if how == "factor":
                    factors = factorize(*args)
                else:
                    factors = refresh(factors, *args)
                state = run(state, factors, n0, n1)

    trajectory = {k: torch.stack([s[k] for s in traj]) for k in traj[0]}
    info = type(infos[0])(*(torch.stack(x) for x in zip(*infos)))
    return state, trajectory, info


def _integrate_diff(model, ini_state, controls_stacked, prop, times,
                    params_d, batch=None):
    """:func:`integrate_pure` as a differentiable eager loop: the windows of
    :func:`_integrate_eager` (factors built or refreshed without a graph,
    from detached inputs), each step by ``model.step_diff`` with its row of
    ``equations.newmark.coefficient_rows`` of ``dts = times[1:] -
    times[:-1]`` (float64, so the times get their gradient).  The step's
    float ``dt`` (the eager loop's) drives the solves and factorizations.
    Info tensors are detached.  ``batch`` as :func:`run_inputs` (the
    model's ``step_diff_batch``)."""
    from .equations import newmark

    dev, dtype = model.device, model.dtype
    state, controls, prop = run_inputs(model, ini_state, controls_stacked, prop, batch)
    _, _, factorize, refresh, step_diff = steppers(model, batch)
    times_t = (times if isinstance(times, torch.Tensor)
               else torch.as_tensor(np.asarray(times, dtype=np.float64)))
    times_t = times_t.to(device=dev, dtype=torch.float64)
    n_steps = times_t.shape[0] - 1
    if n_steps < 1:
        raise ValueError("integrate_pure needs at least two time points")
    dts_t = times_t[1:] - times_t[:-1]
    # tolist, not numpy: the times may be a torch.func transform's tensor
    dts = [float(x) for x in np.diff(np.array(times_t.detach().cpu().tolist()))]
    rows = newmark.coefficient_rows(dts_t).to(dtype)
    n_controls = next(iter(controls.values())).shape[0]

    def control_at(n):
        i = min(n, n_controls - 1)
        return {k: v[i] for k, v in controls.items()}

    def detached(d):
        return {k: v.detach() for k, v in d.items()}

    traj, infos = [], []

    def run(state, factors, n0, n1):
        for n in range(n0, n1):
            state, info = step_diff(state, control_at(n), prop, dts[n], rows[n],
                                    params_d, factors)
            traj.append(state)
            infos.append(info)
        return state

    if int(params_d.get("jacobian_refresh_steps", 1)) <= 1:
        state = run(state, None, 0, n_steps)
    else:
        factors = None
        for n0, n1, how in step_graph.refresh_windows(n_steps, params_d):
            with torch.no_grad():
                args = (detached(state), detached(control_at(n0)),
                        detached(prop), dts[n0], params_d)
                if how == "factor":
                    factors = factorize(*args)
                else:
                    factors = refresh(factors, *args)
            state = run(state, factors, n0, n1)

    trajectory = {k: torch.stack([s[k] for s in traj]) for k in traj[0]}
    info = type(infos[0])(*(torch.stack(x).detach() for x in zip(*infos)))
    return state, trajectory, info


def integrate_linear_pure(
    model,
    ini_state: dict,
    controls_stacked: dict,
    prop: dict,
    times,
    dini_state: dict,
    dcontrols_stacked: dict,
    dprop: dict,
    dtimes,
    params: Optional[dict] = None,
):
    """The run of :func:`integrate_pure` from ``ini_state`` and its
    tangent along ``(dini_state, dcontrols_stacked, dprop, dtimes)``:
    ``(fin_state, dfin_state)``, dicts of tensors.  The JAX package takes
    one ``jax.jvp`` through its scanned integrator with the custom-JVP
    Newton solve (``integrate_pure(..., mode='fwd')``); here the
    differentiable eager loop (:func:`_integrate_diff`, never the step
    graph) runs under ``torch.func.jvp``, and each step's tangent follows
    the rules of its autograd Functions: the
    forward-mode IFT rule of the Newton solve (one solve with
    full-precision factors built at u1), two K5 launches, the banded
    gather and scatter of the tangent.  The tangent controls are
    broadcast to the controls' stacked shape; ``dtimes`` moves the steps'
    coefficient rows (``equations.newmark.coefficient_rows``).  The FSAI
    model's tangents (the JAX package's ``step_pure_fwd``) are not ported:
    it raises."""
    from .models.fsai import ExplicitFSAIModel

    if isinstance(model, ExplicitFSAIModel):
        raise NotImplementedError("tangents of the FSAI model are not ported")
    params_d = solver_params(params)
    dev, dtype = model.device, model.dtype
    if isinstance(times, torch.Tensor):
        times = times.detach().cpu().numpy()
    times_t = torch.as_tensor(np.asarray(times, dtype=np.float64), device=dev)
    primals = (to_tensors(ini_state, dev, dtype), to_tensors(controls_stacked, dev, dtype),
               to_tensors(prop, dev, dtype), times_t)
    tangents = tuple({k: _tensor_like(d[k], v) for k, v in p.items()}
                     for d, p in zip((dini_state, dcontrols_stacked, dprop), primals[:3]))
    tangents += (_tensor_like(dtimes, times_t),)

    def run(state0, controls, prop, times):
        return _integrate_diff(model, state0, controls, prop, times, params_d)[0]

    with torch.no_grad():
        return jvp(run, primals, tangents)


def _tensor_like(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (array or tensor) as a tensor of ``like``'s dtype and device,
    broadcast to its shape (a tangent of ``like``)."""
    t = torch.as_tensor(x.detach() if isinstance(x, torch.Tensor) else np.asarray(x))
    return t.to(device=like.device, dtype=like.dtype).broadcast_to(like.shape).contiguous()


def integrate_linear(
    model,
    f,
    dini_state: dict,
    dcontrols: list,
    dprop: dict,
    dtimes,
    newton_solver_prm: Optional[Options] = None,
):
    """Linearized (tangent) integration about the run stored in the
    statefile ``f`` (reference: ``forward.py:189-244``; the JAX package's
    ``integrate_linear``): the initial state, control schedule, properties
    and times are read from ``f``, and the tangent of the final state along
    ``dini_state``, ``dcontrols`` (a list of control dicts, stacked and
    broadcast as the file's controls), ``dprop`` and ``dtimes`` is returned
    as a dict of numpy arrays in the initial state's key order
    (:func:`integrate_linear_pure`).  ``newton_solver_prm`` are the solver
    parameters of the run (the JAX package's defaults where None)."""
    prop = f.get_prop()
    times = np.asarray(f.get_times())
    ini_state = f.get_state(0)
    ctrl_keys = list(model.control.keys())
    n_rows = f.root_group["control"][ctrl_keys[0]].shape[0]
    controls = [f.get_control(n) for n in range(min(n_rows, f.size))]
    _, dfin = integrate_linear_pure(
        model, ini_state, _stack_controls(model, controls), prop, times,
        dini_state, _stack_controls(model, dcontrols), dprop, dtimes,
        newton_solver_prm)
    dfin = to_numpy(dfin)
    return {k: dfin[k] for k in ini_state}


def _integrate_windowed(
    model,
    state0: dict,
    controls_stacked: dict,
    prop: dict,
    times: np.ndarray,
    params: Optional[dict],
    window: Optional[int] = None,
    use_tqdm: bool = False,
):
    """Chunk the integration into windows of ``window`` steps.

    Each window is one :func:`integrate_pure` call (a graph run replays
    the one graph of its settings in every window); the state carries
    across windows, and each window's trajectory and infos are moved to
    host numpy, which bounds the device memory of long runs."""
    n_steps = len(times) - 1
    if window is None and use_tqdm:
        window = max(1, min(50, n_steps))
    if window is None or window >= n_steps:
        return integrate_pure(model, state0, controls_stacked, prop, times, params)

    starts = list(range(0, n_steps, window))
    iterator = starts
    if use_tqdm:
        from tqdm import tqdm

        iterator = tqdm(starts, unit_scale=window, unit="step")

    trajs, infos_all = [], []
    state = state0
    for s in iterator:
        e = min(s + window, n_steps)
        # shift controls: step n of this window is global step s + n
        ctrl_win = {k: a[min(s, a.shape[0] - 1):] for k, a in controls_stacked.items()}
        state, traj, infos = integrate_pure(
            model, state, ctrl_win, prop, times[s : e + 1], params
        )
        trajs.append(to_numpy(traj))
        infos_all.append(type(infos)(*(x.cpu().numpy() for x in infos)))

    traj = {k: np.concatenate([t[k] for t in trajs], axis=0) for k in trajs[0]}
    infos = type(infos)(*(np.concatenate(xs, axis=0) for xs in zip(*infos_all)))
    return state, traj, infos


def validate_times(times) -> np.ndarray:
    """(reference: ``forward.py:65-72``)"""
    times = np.asarray(times)
    if times.size < 1:
        raise ValueError("There must be at least 1 time integration point.")
    if times[-1] <= times[0]:
        raise ValueError(
            "The final time point must be greater or equal to the initial one."
            f" The input initial/final times were {times[0]}/{times[-1]}"
        )
    return times


def _step_info(infos) -> dict:
    """A run's ``SolveInfo`` as a dict of numpy arrays."""
    return to_numpy(dict(zip(("num_iter", "abs_err", "rel_err"), infos)))


def integrate(
    model,
    f,
    ini_state: dict,
    controls: list,
    prop: dict,
    times,
    idx_meas: Optional[np.ndarray] = None,
    newton_solver_prm: Optional[Options] = None,
    write: bool = True,
    use_tqdm: bool = False,
    window: Optional[int] = None,
):
    """Integrate the model over ``times`` (reference: ``forward.py:22-102``)
    and write the run to the statefile ``f`` (a :class:`~.statefile.StateFile`,
    or None).

    ``controls`` is a list of control dicts; a single entry is held
    constant over the run, otherwise the last entry is held for remaining
    steps (reference: ``forward.py:170``).  ``window`` chunks the run into
    windows of that many steps, each moved to host numpy (bounding device
    memory for long runs); ``use_tqdm`` shows a per-window progress bar
    (needs tqdm).  Returns ``(fin_state, last_info)`` (:func:`finalize_run`).
    """
    if idx_meas is None:
        idx_meas = np.array([])
    times = validate_times(times)

    state0 = to_numpy(ini_state)
    controls_stacked = _stack_controls(model, controls)
    prop_d = to_numpy(prop)
    # models with a restricted supported regime verify the run's
    # properties up front (the FSAI model, ``models.fsai``)
    check = getattr(model, "check_envelope", None)
    if check is not None:
        check(prop_d)

    fin_state, traj, infos = _integrate_windowed(
        model, state0, controls_stacked, prop_d, times, newton_solver_prm,
        window=window, use_tqdm=use_tqdm,
    )
    return finalize_run(
        model, f, ini_state, controls, prop, times, idx_meas,
        newton_solver_prm, fin_state, traj, infos, write,
    )


def finalize_run(
    model,
    f,
    ini_state: dict,
    controls: list,
    prop: dict,
    times: np.ndarray,
    idx_meas,
    newton_solver_prm,
    fin_state: dict,
    traj: dict,
    infos,
    write: bool = True,
):
    """Post-run bookkeeping of :func:`integrate`: statefile writes,
    divergence flagging, and fixed-iteration certification.  Returns
    ``(fin_state, last_info)``: the final state as numpy arrays in the
    initial state's key order, and the last step's ``num_iter``,
    ``abs_err``, ``rel_err`` with ``all`` (every step's), ``diverged``,
    ``diverged_step`` (where diverged) and ``uncertified_steps``."""
    if idx_meas is None:
        idx_meas = np.array([])
    controls_stacked = _stack_controls(model, controls)
    state_keys = list(ini_state.keys())
    fin = to_numpy(fin_state)
    fin = {k: fin[k] for k in state_keys}
    n_steps = len(times) - 1
    step_info = _step_info(infos)

    if write and f is not None:
        f.init_layout()
        # initial state row (reference: ``forward.py:75-86``)
        f.append_state(ini_state)
        f.append_control(controls[0])
        f.append_time(times[0])
        f.append_solver_info({"num_iter": 0, "abs_err": 0, "rel_err": 0})
        f.append_prop(prop)
        if 0 in idx_meas:
            f.append_meas_index(0)

        # trajectory window
        ctrl_traj = {}
        for k, arr in controls_stacked.items():
            idx = np.minimum(np.arange(n_steps), arr.shape[0] - 1)
            ctrl_traj[k] = np.asarray(arr)[idx]
        traj_h = to_numpy(traj)
        f.append_window(
            {k: traj_h[k] for k in state_keys},
            ctrl_traj,
            times[1:],
            step_info,
        )
        for n in idx_meas:
            if n != 0:
                f.append_meas_index(int(n))

    last_info = {
        "num_iter": int(step_info["num_iter"][-1]),
        "abs_err": float(step_info["abs_err"][-1]),
        "rel_err": float(step_info["rel_err"][-1]),
    }
    last_info["all"] = step_info
    # flag NaN/diverged steps instead of silently writing garbage
    bad = ~np.isfinite(step_info["abs_err"])
    if bad.any():
        first = int(np.nonzero(bad)[0][0])
        last_info["diverged"] = True
        last_info["diverged_step"] = first
        warnings.warn(
            f"integrate: non-finite solver residual first at step {first}"
            f" of {n_steps}; simulation likely diverged",
            RuntimeWarning,
        )
    else:
        last_info["diverged"] = False
    last_info["uncertified_steps"] = certify_fixed_iterations(
        newton_solver_prm, step_info
    )
    # runtime half of an envelope guard (the FSAI model):
    # steps whose interactive flow solve fell back to the lagged exchange
    bracketed = getattr(infos, "bracketed", None)
    if bracketed is not None:
        n_lagged = int((~to_numpy({"bracketed": bracketed})["bracketed"]).sum())
        last_info["lagged_fallback_steps"] = n_lagged
        if n_lagged:
            warnings.warn(
                f"integrate: {n_lagged}/{n_steps} FSAI steps could not"
                " bracket the interactive flow root and fell back to"
                " the marginally-unstable lagged exchange — the"
                " configuration is outside the supported envelope"
                " (contact plane must lie below the channel midline)",
                RuntimeWarning,
            )
    return fin, last_info


def certify_fixed_iterations(params: Optional[dict], step_info) -> int:
    """Residual-certify a statically-unrolled fixed-iteration Newton run.

    ``fixed_iterations`` trades the adaptive stagnation stop for fixed
    work per step (the sweep/latency-optimal configs) — but an iteration
    count that certifies on one mesh can silently under-converge on a
    larger one (measured: ``fixed_iterations=2`` left trajectories 8x
    worse at 53k DOFs while 3 was at the noise floor).  Since the
    per-step residuals still stream back through the scan, certification
    is a host-side check: warn when steps stop at a relative residual
    above ``fixed_certify_rel_err`` (default 3e-3 in f32 — above the
    measured chord-Newton stagnation floor — and 1e-6 in f64).

    Returns the number of uncertified steps (0 when the check passes or
    does not apply).

    With ``fixed_tail_residual=False`` (the throughput lever that skips
    the trailing telemetry-only residual assembly), the streamed
    ``abs/rel_err`` report the PENULTIMATE iterate — an upper bound on
    the final one in the chord-contraction regime — so this check
    certifies a bound, not the final residual.  Gate such configs on
    trajectory error against an exact-Jacobian run as well (bench.py's
    large-mesh leg does).
    """
    params = dict(params or {})
    if not params.get("fixed_iterations"):
        return 0
    rel = np.asarray(step_info["rel_err"])
    f32 = rel.dtype == np.float32
    threshold = params.get(
        "fixed_certify_rel_err", 3e-3 if f32 else 1e-6
    )
    # steps that converged absolutely are certified regardless of the
    # relative metric (rel_err ~ 1 on no-load steps where err0 ~ 0)
    absr = np.asarray(step_info["abs_err"])
    abs_ok = absr < params.get("absolute_tolerance", 1e-8)
    bad = np.isfinite(rel) & (rel > threshold) & ~abs_ok
    n_bad = int(bad.sum())
    if n_bad:
        warnings.warn(
            f"integrate: {n_bad}/{rel.size} steps stopped above the"
            f" fixed-iteration certification threshold"
            f" (max rel_err {float(np.nanmax(rel)):.2e} >"
            f" {threshold:.0e}); raise 'fixed_iterations' or drop it to"
            " restore the adaptive stagnation stop",
            RuntimeWarning,
        )
    return n_bad


def integrate_extend(
    model,
    f,
    controls: list,
    times,
    idx_meas=None,
    newton_solver_prm: Optional[Options] = None,
    write: bool = True,
):
    """Resume integration from the last state in the statefile ``f``
    (reference: ``forward.py:105-136``); ``times`` count from the file's
    last time.  Returns ``(fin_state, step_info)``."""
    prop = f.get_prop()
    N = f.size
    ini_state = f.get_state(N - 1)
    ini_time = f.get_time(N - 1)
    times = np.asarray(times) + ini_time

    controls_stacked = _stack_controls(model, controls)
    fin_state, traj, infos = integrate_pure(
        model, ini_state, controls_stacked, prop, times, newton_solver_prm
    )
    state_keys = list(ini_state.keys())
    n_steps = len(times) - 1
    step_info = _step_info(infos)
    if write:
        ctrl_traj = {}
        for k, arr in controls_stacked.items():
            idx = np.minimum(np.arange(n_steps), arr.shape[0] - 1)
            ctrl_traj[k] = np.asarray(arr)[idx]
        f.append_window(
            {k: v for k, v in to_numpy(traj).items() if k in state_keys},
            ctrl_traj,
            times[1:],
            step_info,
        )
    fin = to_numpy(fin_state)
    return {k: fin[k] for k in state_keys}, step_info


def integrate_step(
    model,
    ini_state: dict,
    control: dict,
    prop: dict,
    dt: float,
    options: Optional[Options] = None,
):
    """Single-step integration (reference: ``forward.py:247-268``): one
    ``step_pure`` on the model's device.  Returns ``(state, info)`` as dicts
    of numpy arrays (``num_iter``, ``abs_err``, ``rel_err``)."""
    dev, dtype = model.device, model.dtype
    with torch.no_grad():
        state, info = model.step_pure(
            to_tensors(ini_state, dev, dtype), to_tensors(control, dev, dtype),
            to_tensors(prop, dev, dtype), float(dt), solver_params(options),
        )
    return to_numpy(state), {k: v.item() for k, v in _step_info(info).items()}
