"""
Fluid-state trajectory functionals (counterpart of
``vf_fem_tpu.functional.fluid``).
"""

from __future__ import annotations

import math

import torch

from .base import AbstractFunctional


def _tukey(n: int, alpha: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """Tukey (tapered cosine) window, as ``scipy.signal.windows.tukey``."""
    if alpha <= 0:
        return torch.ones(n, dtype=dtype, device=device)
    x = torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
    if alpha >= 1:
        return 0.5 * (1 - torch.cos(2 * math.pi * x))
    w = torch.ones(n, dtype=dtype, device=device)
    w = torch.where(x < alpha / 2,
                    0.5 * (1 + torch.cos(2 * math.pi / alpha * (x - alpha / 2))), w)
    return torch.where(x >= 1 - alpha / 2,
                       0.5 * (1 + torch.cos(2 * math.pi / alpha * (x - 1 + alpha / 2))), w)


class FluidFunctional(AbstractFunctional):
    pass


class FinalPressureNorm(FluidFunctional):
    """||p(T)||_2."""

    def eval_traj(self, traj, times, controls, props):
        return torch.linalg.vector_norm(traj["p"][-1])


class FinalFlowRateNorm(FluidFunctional):
    """||q(T)||."""

    def eval_traj(self, traj, times, controls, props):
        return torch.linalg.vector_norm(traj["q"][-1])


def _psub_at(controls, n_q):
    """The psub control history aligned with ``n_q`` stored states (a
    shorter history holds its last value)."""
    psub = controls["psub"][:, 0]
    if psub.shape[0] != n_q:
        psub = torch.broadcast_to(psub[-1], (n_q,))
    return psub


class AvgSubglottalPower(FluidFunctional):
    """The time-averaged subglottal power trapz(q psub) / T."""

    default_constants = {"n_start": 0}

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        q = traj["q"][n0:, 0]
        power = q * _psub_at(controls, q.shape[0])
        t = times[n0:]
        total = torch.sum(0.5 * torch.diff(t) * (power[1:] + power[:-1]))
        return total / (t[-1] - t[0])


class AvgAcousticPower(FluidFunctional):
    """The mean radiated acoustic power: a piston-in-baffle radiation
    impedance applied to the spectrum of the windowed flow rate."""

    default_constants = {
        "n_start": 0,
        "rho": 0.001225,
        "c": 350 * 1e2,
        "a": 0.5,
        "tukey_alpha": 0.05,
    }

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        q = traj["q"][n0:-1, 0]
        t = times[n0:-1]
        qw = _tukey(q.shape[0], self.constants["tukey_alpha"], q.dtype, q.device) * q
        dft_qw = torch.fft.fft(qw)
        dft_freq = torch.fft.fftfreq(qw.shape[0], d=1.0, dtype=t.dtype,
                                     device=t.device) / (t[1] - t[0])
        rho, c, a = (self.constants[k] for k in ("rho", "c", "a"))
        k = 2 * math.pi * dft_freq / c
        z = 0.5 * (k * a) ** 2 + 1j * 8 * k * a / (3 * math.pi)
        z_rad = z * rho * c / (math.pi * a**2)
        psd = torch.real(z_rad) * torch.abs(dft_qw) ** 2
        n = qw.shape[0]
        return torch.sum(psd) / n / n


class SubglottalWork(FluidFunctional):
    """The total subglottal work trapz(q psub) over the run."""

    default_constants = {"n_start": 0}

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        q = traj["q"][n0:, 0]
        power = q * _psub_at(controls, q.shape[0])
        return torch.sum(0.5 * torch.diff(times[n0:]) * (power[1:] + power[:-1]))
