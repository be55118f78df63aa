"""
Two-way coupled fluid-solid-acoustic interaction (FSAI): counterpart of
``vf_fem_tpu.models.fsai``.

Inside every step the glottal flow drives the wave-reflection-analog tract
(``models.acoustic``) and the tract's glottal-end pressure feeds back as
the fluid's supraglottal pressure:

1. the solid's Newton step under the previous step's fluid pressure
   (staggered, as in ``ExplicitFSIModel``);
2. the WRA half step exposes the tract's instantaneous input-pressure law
   ``psup = z q + 2 b2``; the quasi-steady fluid and that law are solved
   together by a bracketed root solve on the scalar ``q``
   (:func:`solve_flow_root`), so acoustic loading acts on the flow with no
   delay;
3. the WRA full step, driven by the converged glottal flow.

The tract's time step is locked to its geometry (``dt = 2 L / (N c)``):
drive the model at ``model.dt``.  Phonation-like configurations place the
contact plane below the midline (``ycontact < ymid``) so that collision
stops closure at a positive glottal area (:meth:`ExplicitFSAIModel.
check_envelope`); a step whose root solve finds no sign change falls back
to the one-step-lagged exchange and says so in its ``bracketed`` info.

The root solve is a Python loop of fixed length on the device: no ``if`` on
a tensor and no host read, so the step captures as one CUDA graph
(``step_graph``) like the FSI step.  Gradients are exact by the
implicit-function theorem: the bracketing runs without autograd and the
two chord-Newton polish steps at the root are differentiable.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jvp

from .acoustic import WRAnalog, make_wra_parts
from .transient import ExplicitFSIModel

__all__ = ["ExplicitFSAIModel", "FSAISolveInfo", "solve_flow_root"]


class FSAISolveInfo(NamedTuple):
    """A step's solver telemetry: the solid Newton's ``SolveInfo`` fields
    and ``bracketed``, whether the interactive flow root solve bracketed a
    sign change (a step without one fell back to the lagged exchange;
    ``forward.finalize_run`` counts them as ``lagged_fallback_steps``)."""

    num_iter: torch.Tensor
    abs_err: torch.Tensor
    rel_err: torch.Tensor
    bracketed: torch.Tensor


def solve_flow_root(fluid_at, q0, n_expand=6, n_bisect=20):
    """Solve the interactive source-tract flow ``q = Q(psup(q))``.

    ``fluid_at(q)`` evaluates the quasi-steady fluid at the tract's
    instantaneous input pressure ``psup(q) = z q + 2 b2`` and returns the
    fluid state dict; ``q0`` is the previous step's flow (the lagged
    fallback).

    Bracketed bisection on ``g(q) = Q(psup(q)) - q``, which is strictly
    decreasing in the physical regime, so it converges whatever the loop
    gain: the interval ``[q0, f(q0)]`` widened by 5% is expanded
    ``n_expand`` times (doubling its step) while ``g`` keeps its sign at
    both ends, then halved ``n_bisect`` times, all without autograd.  The
    root is polished by two differentiable chord-Newton steps with the
    exact slope ``g'`` at the bisection's midpoint (a forward-mode
    derivative, detached; ``|g'| < 0.25`` is taken as -1), which makes the
    gradient the implicit-function theorem's.  Where no sign change was
    bracketed the fluid is evaluated at ``q0``.

    Returns ``(fluid_state_dict, bracketed)``; ``bracketed`` is a 0-d
    bool tensor."""

    def f(q):
        return fluid_at(q)["q"].reshape(())

    def fng(q):  # values only, for the bracketing phase
        with torch.no_grad():
            return f(q.detach())

    q0s = q0.detach().reshape(())
    f0 = fng(q0s)
    a = torch.minimum(q0s, f0)
    b = torch.maximum(q0s, f0)
    w = torch.maximum(b - a, 1e-3 * (1.0 + torch.abs(q0s)))
    a = a - 0.05 * w
    b = b + 0.05 * w
    ga = fng(a) - a
    gb = fng(b) - b
    for _ in range(n_expand):
        need = ga * gb > 0.0
        a = torch.where(need, a - w, a)
        b = torch.where(need, b + w, b)
        ga = torch.where(need, fng(a) - a, ga)
        gb = torch.where(need, fng(b) - b, gb)
        w = 2.0 * w
    bracketed = ga * gb <= 0.0
    for _ in range(n_bisect):
        m = 0.5 * (a + b)
        gm = fng(m) - m
        left = ga * gm <= 0.0
        a, b, ga, gb = (torch.where(left, a, m), torch.where(left, m, b),
                        torch.where(left, ga, gm), torch.where(left, gm, gb))
    q_star = (0.5 * (a + b)).detach()

    with torch.no_grad():
        dg = jvp(f, (q_star,), (torch.ones_like(q_star),))[1] - 1.0
    # physically g' <= -1; guard the (measure-zero) g' ~ 0 pathology
    dg = torch.where(torch.abs(dg) < 0.25, -1.0, dg)
    q_ref = q_star - (f(q_star) - q_star) / dg
    q_ref = q_ref - (f(q_ref) - q_ref) / dg

    q_out = torch.where(bracketed, q_ref, q0.reshape(()))
    return fluid_at(q_out), bracketed


class ExplicitFSAIModel:
    """Two-way coupled FSI + WRA acoustics.

    State ``{u, v, a, q, p, pinc, pref}``; control: the FSI model's without
    ``psup`` (the tract provides it); properties: the FSI model's then the
    tract's.  ``state0``, ``control`` and ``prop`` are dicts of the FSI
    model's and the tract's own numpy arrays (not copies): setting an entry
    in place sets it in both.  The step functions have the FSI model's
    signatures (``forward``, ``step_graph`` and ``adjoint`` call them);
    the solver parameters ``fsai_expand_iterations`` (6) and
    ``fsai_bisect_iterations`` (20) set the root solve's budget."""

    info_type = FSAISolveInfo

    def __init__(self, fsi: ExplicitFSIModel, acoustic: WRAnalog):
        if type(fsi) is not ExplicitFSIModel:
            raise TypeError("FSAI couples the tract to an explicitly coupled FSI model")
        if (fsi.device, fsi.dtype) != (acoustic.device, acoustic.dtype):
            raise ValueError("the FSI model and the tract must share device and dtype")
        self.fsi, self.acoustic = fsi, acoustic
        self.solid, self.fluid = fsi.solid, fsi.fluid
        self.device, self.dtype = fsi.device, fsi.dtype
        self.state0 = {**fsi.state0, **acoustic.state0}
        self._ext_control_keys = [k for k in fsi.control if k != "psup"]
        self.control = {k: fsi.control[k] for k in self._ext_control_keys}
        self._ac_prop_keys = list(acoustic.prop)
        if set(fsi.prop) & set(acoustic.prop):
            raise ValueError("FSI/acoustic property name collision")
        self.prop = {**fsi.prop, **acoustic.prop}
        self._half, self._full, self._input_coeffs = make_wra_parts(acoustic.num_tube)

    # -- the coupled step ------------------------------------------------------------
    def _ac_prop(self, prop: dict) -> dict:
        return {k: prop[k] for k in self._ac_prop_keys}

    def _fluid_control(self, area, control, psup):
        return {"area": area, **{k: control[k] for k in self._ext_control_keys},
                "psup": psup}

    def _solve_flow(self, u1, state0, control, prop, params):
        """The interactive source: ``q`` against the tract's input-pressure
        law, jointly with the quasi-steady fluid (:func:`solve_flow_root`).
        Returns the fluid state, the half step's ``pinc_1`` and
        ``bracketed``."""
        ac_prop = self._ac_prop(prop)
        _, fl_prop = self.fsi._split_prop(prop)
        pinc_1 = self._half(state0["pinc"], state0["pref"], ac_prop)
        z0, b2_0 = self._input_coeffs(pinc_1, ac_prop)
        area = self.fsi._area_from_u1(u1, prop)
        proto = {"q": state0["q"], "p": state0["p"]}

        def fluid_at(q):
            psup = (z0 * q + 2.0 * b2_0).reshape((1,))
            return self.fluid.solve_pure(self._fluid_control(area, control, psup),
                                         fl_prop, proto)

        pd = dict(params or {})
        qp, bracketed = solve_flow_root(
            fluid_at, state0["q"], n_expand=int(pd.get("fsai_expand_iterations", 6)),
            n_bisect=int(pd.get("fsai_bisect_iterations", 20)))
        return qp, pinc_1, bracketed

    def _couple(self, uva1, info, state0, control, prop, params):
        """A step's fluid and tract after its solid solve."""
        qp1, pinc_1, bracketed = self._solve_flow(uva1["u"], state0, control, prop, params)
        pinc1, pref1 = self._full(pinc_1, state0["pinc"], state0["pref"], qp1["q"],
                                  self._ac_prop(prop))
        return ({**uva1, **qp1, "pinc": pinc1, "pref": pref1},
                FSAISolveInfo(*info, bracketed))

    def step_pure(self, state0, control, prop, dt, params=None, dt_next=None):
        """One coupled step, the solid re-assembling its Jacobian in each
        solve (``dt_next`` as in ``ExplicitFSIModel.step_pure``)."""
        sl_state0, sl_control, sl_prop = self.fsi._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_pure(sl_state0, sl_control, sl_prop, dt,
                                                  params, dt_next)
        return self._couple(uva1, info, state0, control, prop, params)

    def factorize(self, state0, control, prop, dt, params=None):
        return self.fsi.factorize(state0, control, prop, dt, params)

    def refresh_factors(self, factors, state0, control, prop, dt, params=None):
        return self.fsi.refresh_factors(factors, state0, control, prop, dt, params)

    def step_pure_stale(self, factors, state0, control, prop, dt, params=None,
                        dt_next=None):
        """One coupled step with carried Jacobian factors."""
        sl_state0, sl_control, sl_prop = self.fsi._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_stale(factors, sl_state0, sl_control,
                                                   sl_prop, dt, params, dt_next)
        return self._couple(uva1, info, state0, control, prop, params)

    def step_diff(self, state0, control, prop, dt, row, params=None, factors=None):
        """One coupled step as a differentiable function of the state,
        control, properties and the step's coefficient row (the solid's IFT
        rule, ``SolidModel.solve_state1_diff``, then the root solve's
        differentiable polish and the tract); its values are
        :meth:`step_pure`'s / :meth:`step_pure_stale`'s bit for bit."""
        sl_state0, sl_control, sl_prop = self.fsi._solid_inputs(state0, prop)
        uva1, info = self.solid.solve_state1_diff(sl_state0, sl_control, sl_prop, dt,
                                                  row, params, factors)
        return self._couple(uva1, info, state0, control, prop, params)

    def res_pure(self, state1, state0, control, prop, dt):
        """The coupled step's residual of every block at ``state1``: the
        solid's under the previous step's pressure, the fluid's at the
        tract's input pressure ``psup(q1)``, the tract's update."""
        sl_state0, sl_control, sl_prop = self.fsi._solid_inputs(state0, prop)
        res = self.solid.res_pure({k: state1[k] for k in ("u", "v", "a")}, sl_state0,
                                  sl_control, sl_prop, dt)
        ac_prop = self._ac_prop(prop)
        _, fl_prop = self.fsi._split_prop(prop)
        pinc_1 = self._half(state0["pinc"], state0["pref"], ac_prop)
        z0, b2_0 = self._input_coeffs(pinc_1, ac_prop)
        area = self.fsi._area_from_u1(state1["u"], prop)
        psup = (z0 * state1["q"].reshape(()) + 2.0 * b2_0).reshape((1,))
        res.update(self.fluid.res_pure({"q": state1["q"], "p": state1["p"]},
                                       self._fluid_control(area, control, psup), fl_prop))
        pinc1, pref1 = self._full(pinc_1, state0["pinc"], state0["pref"], state1["q"],
                                  ac_prop)
        res.update(pinc=state1["pinc"] - pinc1, pref=state1["pref"] - pref1)
        return res

    # -- envelope and time step --------------------------------------------------------
    def check_envelope(self, prop: Optional[dict] = None) -> bool:
        """Warn (RuntimeWarning) when the contact plane does not lie below
        the channel midline (``ycontact < ymid``): there, large oscillations
        can drive the fluid into the clamped-area regime where the flow
        root solve fails to bracket and steps fall back to the lagged
        exchange.  ``forward.integrate`` calls it with the run's
        properties.  Returns True inside the envelope."""
        if prop is None:
            prop = self.prop
        yc = float(np.asarray(prop["ycontact"]).ravel()[0])
        ymid = float(np.asarray(prop["ymid"]).ravel()[0])
        if not yc < ymid:
            warnings.warn(
                "FSAI configuration outside the supported envelope: the"
                f" contact plane (ycontact={yc:g}) must lie BELOW the"
                f" channel midline (ymid={ymid:g}) so collision stops"
                " closure at a positive glottal area.  In the clamped-"
                "area regime the interactive flow solve can fail to"
                " bracket and steps fall back to the marginally-unstable"
                " lagged exchange (watch the 'lagged_fallback_steps'"
                " run info).",
                RuntimeWarning,
            )
            return False
        return True

    @property
    def dt(self) -> float:
        """The tract's geometry-locked time step: drive the model at it."""
        return self.acoustic.dt

    @dt.setter
    def dt(self, value):
        ac_dt = self.acoustic.dt
        if abs(float(value) - ac_dt) > 1e-12 * ac_dt:
            raise ValueError(f"FSAI dt is locked to the tract: {ac_dt!r}")
