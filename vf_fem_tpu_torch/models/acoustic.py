"""
1D wave-reflection-analog (WRA) vocal-tract acoustics (counterpart of
``vf_fem_tpu.models.acoustic``).

The tract is N equal-length tube segments; the state holds interlaced
forward/backward partial pressures at even junctions:

- ``pinc`` (incident: f1, b2 interlaced), ``pref`` (reflected: b1, f2),
  each of length ``(N//2 + 1) * 2``
- control: glottal flow ``qin``
- props: ``length, area (N,), proploss (N,), rhoac, soundspeed, rrad, lrad``

One acoustic step = reflections at odd junctions (half step) then at even
junctions including the flow-source input junction and the Story/Flanagan
piston radiation load at the mouth (R = 128/(9 pi^2),
L = 16/dt * a_piston / (3 pi c)).  The time step is pinned by the tract's
geometry: dt = (2 L / N) / c.

The update is plain tensor arithmetic on the properties' device and dtype:
no tensor is made from Python numbers or host arrays inside a step (the
FSAI step runs inside a captured CUDA graph, ``step_graph``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..convert import to_numpy, to_tensors
from ..solvers.newton import SolveInfo
from .transient import BaseTransientModel


def make_wra_parts(n_tube: int):
    """Return ``(half, full, input_coeffs)``, the phases of the WRA update:

    - ``half(pinc, pref, prop) -> pinc_1``: reflections at odd junctions,
      producing the incident partial pressures at even junctions.  The
      glottal flow does not enter yet, so the input junction's incoming
      backward wave ``b2 = gamma2[0] * pinc_1[1]`` (and hence the tract's
      instantaneous input pressure ``p = z q + 2 b2``) is known before
      ``q`` is chosen: what lets the FSAI model couple source and tract
      within one step (``models.fsai``).
    - ``full(pinc_1, pinc, pref, qin, prop) -> (pinc1, pref1)``:
      reflections at even junctions including the flow-source input and
      the piston radiation load.
    - ``input_coeffs(pinc_1, prop) -> (z, b2)``: the input-pressure law
      ``p = z q + 2 b2`` of the step.
    """
    if n_tube % 2:
        raise ValueError(f"the WRA tract needs an even number of tubes, not {n_tube}")

    def _setup(prop):
        area = prop["area"]
        gamma = prop["proploss"]
        rho = prop["rhoac"][0]
        c = prop["soundspeed"][0]
        length = prop["length"][0]
        dt = (2 * length / n_tube) / c

        # piston radiation constants (Story & Flanagan)
        piston_rad = torch.sqrt(area[-1] / math.pi)
        R = 128.0 / (9 * math.pi**2)
        L = 16.0 / dt * piston_rad / (3 * math.pi * c)

        # areas/losses left (1) and right (2) of even junctions; the end
        # entries are fictitious
        one = area.new_ones(1)
        a1 = torch.cat([one, area[1::2]])
        a2 = torch.cat([area[:-1:2], one])
        gamma1 = torch.cat([one, gamma[1::2]])
        gamma2 = torch.cat([gamma[:-1:2], one])
        z1 = rho * c / a1
        z2 = rho * c / a2
        return gamma1, gamma2, z1, z2, R, L

    def interlace(x, y):
        return torch.stack([x, y], dim=-1).reshape(-1)

    def half(pinc, pref, prop):
        gamma1, gamma2, z1, z2, _, _ = _setup(prop)

        def reflect05(pinc_05):
            z1_, z2_ = z2[:-1], z1[1:]
            g1_, g2_ = gamma2[:-1], gamma1[1:]
            f1 = g1_ * pinc_05[:-1:2]
            b2 = g2_ * pinc_05[1::2]
            r = (z2_ - z1_) / (z2_ + z1_)
            b1 = b2 + (f1 - b2) * r
            f2 = f1 + (f1 - b2) * r
            return interlace(b1, f2)

        # half step: reflected (even) -> incident at odd junctions
        b1, f2 = pref[:-1:2], pref[1::2]
        pref_05 = reflect05(interlace(f2[:-1], b1[1:]))
        b1_05, f2_05 = pref_05[:-1:2], pref_05[1::2]

        zero = pref.new_zeros(1)
        return interlace(torch.cat([zero, f2_05]), torch.cat([b1_05, zero]))

    def full(pinc_1, pinc, pref, qin, prop):
        gamma1, gamma2, z1, z2, R, L = _setup(prop)

        def inputq(q, pinc_inp):
            z, g = z2[0], gamma2[0]
            f1, b2 = pinc_inp[0], pinc_inp[1]
            b2 = g * b2
            f2 = z * q + b2
            b1 = b2 + f2 - f1
            return torch.stack([b1, f2])

        def radiation(pinc_rad, pinc_rad_prev, pref_rad_prev):
            g = gamma1[-1]
            f1prev = pinc_rad_prev[0]
            b1prev, f2prev = pref_rad_prev[0], pref_rad_prev[1]
            f1 = g * pinc_rad[0]
            _a1 = -R + L - R * L
            _a2 = -R - L + R * L
            _b1 = -R + L + R * L
            _b2 = R + L + R * L
            b1 = 1 / _b2 * (f1 * _a2 + f1prev * _a1 + b1prev * _b1)
            f2 = 1 / _b2 * (f2prev * _b1 + f1 * (_b2 + _a2) + f1prev * (_a1 - _b1))
            return torch.stack([b1, f2])

        def reflect00(pinc_1, pinc_prev, pref_prev, q):
            f1 = gamma1 * pinc_1[:-1:2]
            b2 = gamma2 * pinc_1[1::2]
            r1 = (z2 - z1) / (z2 + z1)
            f2int = (f1 + (f1 - b2) * r1)[1:-1]
            b1int = (b2 + (f1 - b2) * r1)[1:-1]
            pref_inp = inputq(q, pinc_1[:2])
            pref_rad = radiation(pinc_1[-2:], pinc_prev[-2:], pref_prev[-2:])
            return torch.cat([pref_inp, interlace(b1int, f2int), pref_rad])

        return pinc_1, reflect00(pinc_1, pinc, pref, qin.reshape(()))

    def input_coeffs(pinc_1, prop):
        """The tract's input-pressure law ``p = z q + 2 b2`` at this step:
        ``(z, b2)``, ``b2`` the attenuated incoming backward wave at the
        input junction."""
        _, gamma2, _, z2, _, _ = _setup(prop)
        return z2[0], gamma2[0] * pinc_1[1]

    return half, full, input_coeffs


def make_wra_step(n_tube: int):
    """Return ``step(pinc, pref, qin, prop) -> (pinc1, pref1)``, the WRA
    update."""
    half, full, _ = make_wra_parts(n_tube)

    def step(pinc, pref, qin, prop):
        return full(half(pinc, pref, prop), pinc, pref, qin, prop)

    return step


class WRAnalog(BaseTransientModel):
    """Transient WRA tract model (``vf_fem_tpu.models.acoustic.WRAnalog``):
    state ``{pinc, pref}``, control ``{qin}``, the properties of the module
    docstring, as dicts of numpy arrays (defaults: a 17.46 cm tract of unit
    areas, no loss, air at 1.225e-3 g/cm^3 and 340 m/s).  Its step has no
    solve (its info is zeros) and its ``dt`` is locked to the geometry."""

    def __init__(self, num_tube: int = 44, device=config.DEFAULT_DEVICE,
                 dtype=config.DEFAULT_DTYPE):
        self._step = make_wra_step(num_tube)
        self.num_tube = num_tube
        self.device, self.dtype = config.model_device(device), dtype
        n_junc2 = (num_tube // 2 + 1) * 2
        self.state0 = {"pinc": np.zeros(n_junc2), "pref": np.zeros(n_junc2)}
        self.state1 = {"pinc": np.zeros(n_junc2), "pref": np.zeros(n_junc2)}
        self.control = {"qin": np.zeros(1)}
        self.prop = {
            "length": np.full(1, 17.46),  # tract length ~17.5 cm
            "area": np.ones(num_tube),
            "proploss": np.full(num_tube, 1.0),
            "rhoac": np.full(1, 1.225e-3),
            "soundspeed": np.full(1, 340e2),
            "rrad": np.ones(1),
            "lrad": np.ones(1),
        }

    @property
    def dt(self) -> float:
        """The geometry-locked time step ``(2 L / N) / c``."""
        length = float(self.prop["length"][0])
        c = float(self.prop["soundspeed"][0])
        return (2 * length / self.num_tube) / c

    @dt.setter
    def dt(self, value):
        raise NotImplementedError("You can't set the time step of a WRAnalog tube")

    def step_pure(self, state0, control, prop, dt, params=None, dt_next=None):
        """One tract step (``dt`` is the tract's own; the argument is the
        transient models' signature)."""
        pinc1, pref1 = self._step(state0["pinc"], state0["pref"], control["qin"], prop)
        zero = pinc1.new_zeros(())
        info = SolveInfo(torch.zeros((), dtype=torch.int64, device=pinc1.device), zero, zero)
        return {"pinc": pinc1, "pref": pref1}, info

    def solve_state1(self, state1=None, options=None):
        """The tract's step from the model's ``state0`` under its ``control``
        and ``prop`` (there is nothing to solve: the info is empty)."""
        state0, control, prop = self._tensors(self.state0, self.control, self.prop)
        with torch.no_grad():
            out, _ = self.step_pure(state0, control, prop, self.dt)
        return to_numpy(out), {}

    def assem_res(self) -> dict:
        """``state1`` minus the step's update."""
        out, _ = self.solve_state1()
        return {k: self.state1[k] - out[k] for k in ("pinc", "pref")}


def input_and_output_impedance(model: WRAnalog, n: int = 2**12):
    """Impulse-response input/output impedances of the tract (the JAX
    package's ``input_and_output_impedance``): ``n`` steps from an impulse
    of unit flow seeded at the input junction, on the model's device, then
    the FFT ratios on the host.  Returns ``(zinp, zout)``, complex numpy
    arrays of length ``n``."""
    prop = to_tensors(model.prop, model.device, model.dtype)
    n_junc2 = (model.num_tube // 2 + 1) * 2
    qimp = 1.0
    z0 = prop["rhoac"][0] * prop["soundspeed"][0] / prop["area"][0]
    pinc = torch.zeros(n_junc2, dtype=model.dtype, device=model.device)
    pref = torch.zeros_like(pinc)
    pref[0] = z0 * qimp
    pref[1] = z0 * qimp
    qin = torch.zeros(1, dtype=model.dtype, device=model.device)
    pinp, pout = [pinc[0] + pref[0]], [pinc[-1] + pref[-1]]
    with torch.no_grad():
        for _ in range(n - 1):
            pinc, pref = model._step(pinc, pref, qin, prop)
            pinp.append(pinc[0] + pref[0])
            pout.append(pinc[-1] + pref[-1])
    pinp = torch.stack(pinp).cpu().numpy()
    pout = torch.stack(pout).cpu().numpy()
    qinp = np.zeros(n)
    qinp[0] = qimp
    zinp = np.fft.fft(pinp) / np.fft.fft(qinp)
    zout = np.fft.fft(pout) / np.fft.fft(qinp)
    return zinp, zout
