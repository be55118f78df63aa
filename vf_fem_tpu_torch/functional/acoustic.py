"""
Acoustic functionals (counterpart of ``vf_fem_tpu.functional.acoustic``),
on the trajectories of the WRA tract (``models.acoustic.WRAnalog``) and of
the FSAI model (``models.fsai``): the radiated pressure is the sum of the
incident and reflected partial pressures at the mouth end.
"""

from __future__ import annotations

import torch

from .base import AbstractFunctional


class RmsRadiatedPressure(AbstractFunctional):
    """RMS radiated mouth pressure over the trajectory (trapezoidal in
    time, from step ``n_start``)."""

    default_constants = {"n_start": 0}

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        prad = traj["pinc"][n0:, -1] + traj["pref"][n0:, -1]
        t = times[n0:]
        dt = torch.diff(t)
        mean_sq = torch.sum(0.5 * dt * (prad[1:] ** 2 + prad[:-1] ** 2)) / (t[-1] - t[0])
        return torch.sqrt(mean_sq)


class AcousticPower(AbstractFunctional):
    """Mean acoustic power radiated at the mouth: ``A f^2 / (rho c)`` of
    the forward-travelling partial pressure ``f`` at the last tract
    section, averaged over the trajectory (trapezoidal in time)."""

    default_constants = {"n_start": 0, "rho": 0.001225, "c": 350e2}

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        f_wave = traj["pref"][n0:, -1]
        rho = props["rhoac"][0]
        c = props["soundspeed"][0]
        area = props["area"][-1]
        power = area * f_wave**2 / (rho * c)
        t = times[n0:]
        dt = torch.diff(t)
        return torch.sum(0.5 * dt * (power[1:] + power[:-1])) / (t[-1] - t[0])
