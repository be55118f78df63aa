"""
1D quasi-steady Bernoulli fluid residuals on the port's paths
(``BernoulliAreaRatioSep``, the forward main path's, and
``BernoulliSmoothMinSep``, the differentiable default of the gradient
tests), the same physics and layouts as ``vf_fem_tpu.residuals.fluid``:

- state ``{q, p}``; control ``{area, psub, psup}``; props
  ``{rho_air, r_sep, area_lb}`` (``{rho_air, zeta_sep, zeta_min}``)
- ``q = sign(dp) sqrt(2/rho |dp| / (asep^-2 - asub^-2))`` and
  ``p = psep + rho q^2 (asep^-2 - a^-2) / 2``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..equations.smoothapprox import smooth_min_weight, wavg
from .base import FunctionalResidual

# the JAX package's floor of the smooth variant's area (``_AREA_FLOOR``):
# at full closure area**-2 -> inf, whose gradient is NaN where the value is
# finite; far below any phonatory area, so it changes no physics
AREA_FLOOR = 1e-8


def bernoulliq_from_psub_psep(psub, psep, area_sub, area_sep, rho):
    """Flow rate from the pressure drop."""
    flow_sign = torch.sign(psub - psep)
    return flow_sign * (
        2 / rho * torch.abs(psub - psep) / (area_sep**-2 - area_sub**-2)
    ) ** 0.5


def bernoullip_from_q_psep(qsub, psep, area_sep, area, rho):
    """Pressure from the flow rate."""
    return psep + 1 / 2 * rho * qsub**2 * (area_sep**-2 - area**-2)


class PredefinedFluidResidual(FunctionalResidual):
    def __init__(self, mesh: np.ndarray, device=config.DEFAULT_DEVICE,
                 dtype=config.DEFAULT_DTYPE):
        self._mesh = np.asarray(mesh)
        s = torch.as_tensor(self._mesh, dtype=dtype,
                            device=config.model_device(device))
        res, res_args = self._make_residual(s)
        super().__init__(res, res_args)

    def mesh(self):
        return self._mesh

    def _make_residual(self, s: torch.Tensor):
        raise NotImplementedError("Subclasses must implement this method")


class BernoulliAreaRatioSep(PredefinedFluidResidual):
    """Separation where the area first exceeds ``r_sep * a_min`` downstream
    of the minimum.  Forward-exact but non-smooth (argmin-style masks)."""

    def _make_residual(self, s: torch.Tensor):
        shape_fluid = tuple(s.shape[:-1])
        n_fluid = int(np.prod(shape_fluid)) if shape_fluid else 1
        n_total = s.numel()

        def bernoulli_qp(area, psub, psup, rho, r_sep, area_lb):
            area = torch.maximum(area, area_lb)
            amin = torch.amin(area, dim=-1, keepdim=True)
            # first index of the minimum (ties: the first, as jnp.argmax)
            idx_min = torch.argmax((area == amin).to(area.dtype), dim=-1,
                                   keepdim=True)
            s_b = s.expand_as(area)
            smin = torch.gather(s_b, -1, idx_min)

            asep = r_sep * amin
            # only coordinates downstream of the minimum can separate
            _area = torch.where(s_b >= smin, area, 1e30)
            gap = torch.abs(_area - asep)
            idx_sep = torch.argmin(gap, dim=-1, keepdim=True)
            ssep = torch.gather(s_b, -1, idx_sep)

            f_sep = (s_b < ssep).to(area.dtype)

            q = bernoulliq_from_psub_psep(psub, psup, math.inf, asep, rho)
            p = bernoullip_from_q_psep(q, psup, asep, area, rho)
            p = f_sep * p + (1 - f_sep) * psup
            return q, p

        def res(state, control, prop):
            q = state["q"].reshape(*shape_fluid, 1)
            p = state["p"].reshape(*shape_fluid, -1)
            area = control["area"].reshape(*shape_fluid, -1)
            psub = control["psub"].reshape(*shape_fluid, 1)
            psup = control["psup"].reshape(*shape_fluid, 1)
            rho = prop["rho_air"].reshape(*shape_fluid, 1)
            r_sep = prop["r_sep"].reshape(*shape_fluid, 1)
            area_lb = prop["area_lb"].reshape(*shape_fluid, 1)
            q_, p_ = bernoulli_qp(area, psub, psup, rho, r_sep, area_lb)
            return {"q": (q - q_).reshape(-1), "p": (p - p_).reshape(-1)}

        _state = {"q": np.ones(n_fluid), "p": np.ones(n_total)}
        _control = {
            "area": np.ones(n_total),
            "psub": np.ones(n_fluid),
            "psup": np.ones(n_fluid),
        }
        _props = {
            "rho_air": np.ones(n_fluid),
            "r_sep": np.ones(n_fluid),
            "area_lb": np.zeros(n_fluid),
        }
        return res, (_state, _control, _props)


class BernoulliSmoothMinSep(PredefinedFluidResidual):
    """Softmax smooth-min area and a sigmoid separation cut-off: fully
    differentiable (``vf_fem_tpu.residuals.fluid.BernoulliSmoothMinSep``,
    each of ``zeta_min``, ``zeta_sep`` its own property)."""

    def _make_residual(self, s: torch.Tensor):
        shape_fluid = tuple(s.shape[:-1])
        n_fluid = int(np.prod(shape_fluid)) if shape_fluid else 1
        n_total = s.numel()

        def bernoulli_qp(area, psub, psup, rho, zeta_min, zeta_sep):
            area = torch.maximum(area, area.new_tensor(AREA_FLOOR))
            wmin = smooth_min_weight(area, zeta_min, axis=-1)
            amin = wavg(s, area, wmin, axis=-1)[..., None]
            smin = wavg(s, s * torch.ones_like(area), wmin, axis=-1)[..., None]
            q = bernoulliq_from_psub_psep(psub, psup, math.inf, amin, rho)
            p = bernoullip_from_q_psep(q, psup, amin, area, rho)
            return q, torch.sigmoid(-(s - smin) / zeta_sep) * p

        def res(state, control, prop):
            q = state["q"].reshape(*shape_fluid, 1)
            p = state["p"].reshape(*shape_fluid, -1)
            area = control["area"].reshape(*shape_fluid, -1)
            psub = control["psub"].reshape(*shape_fluid, 1)
            psup = control["psup"].reshape(*shape_fluid, 1)
            rho = prop["rho_air"].reshape(*shape_fluid, 1)
            zeta_min = prop["zeta_min"].reshape(*shape_fluid, 1)
            zeta_sep = prop["zeta_sep"].reshape(*shape_fluid, 1)
            q_, p_ = bernoulli_qp(area, psub, psup, rho, zeta_min, zeta_sep)
            return {"q": (q - q_).reshape(-1), "p": (p - p_).reshape(-1)}

        _state = {"q": np.ones(n_fluid), "p": np.ones(n_total)}
        _control = {
            "area": np.ones(n_total),
            "psub": np.ones(n_fluid),
            "psup": np.ones(n_fluid),
        }
        _props = {
            "rho_air": np.ones(n_fluid),
            "zeta_sep": np.ones(n_fluid),
            "zeta_min": np.ones(n_fluid),
        }
        return res, (_state, _control, _props)
