"""
1D quasi-steady Bernoulli fluid residuals, all four of
``vf_fem_tpu.residuals.fluid`` with the same physics and layouts:

- state ``{q, p}``; control ``{area, psub, psup}`` (``{area, qsub, psup}``
  for the flow-driven ``BernoulliFlowFixedSep``); props ``{rho_air}`` and
  each variant's own (``r_sep, area_lb``; ``zeta_sep, zeta_min``)
- ``q = sign(dp) sqrt(2/rho |dp| / (asep^-2 - asub^-2))`` and
  ``p = psep + rho q^2 (asep^-2 - a^-2) / 2``
- multiple stacked 1D channels by leading dimensions of the arc-length
  coordinates ``s``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..equations.smoothapprox import smooth_min_weight, wavg
from .base import FunctionalResidual

# the JAX package's area floor of the smooth and fixed-separation variants
# (``_AREA_FLOOR``):
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
    """A fluid residual on the arc-length coordinates ``mesh``; further
    arguments (``idx_sep`` of the fixed-separation variants) go to
    ``_make_residual``."""

    def __init__(self, mesh: np.ndarray, *args, device=config.DEFAULT_DEVICE,
                 dtype=config.DEFAULT_DTYPE, **kwargs):
        self._mesh = np.asarray(mesh)
        self.device, self.dtype = config.model_device(device), dtype
        s = torch.as_tensor(self._mesh, dtype=dtype, device=self.device)
        res, res_args = self._make_residual(s, *args, **kwargs)
        super().__init__(res, res_args)

    def mesh(self):
        return self._mesh

    def _make_residual(self, s: torch.Tensor):
        raise NotImplementedError("Subclasses must implement this method")


def _shapes(s: torch.Tensor):
    shape_fluid = tuple(s.shape[:-1])
    n_fluid = int(np.prod(shape_fluid)) if shape_fluid else 1
    return shape_fluid, n_fluid, s.numel()


def _reshape_qp_state(shape_fluid, state):
    return (state["q"].reshape(*shape_fluid, 1),
            state["p"].reshape(*shape_fluid, -1))


def _reshape_control(shape_fluid, control, flow_key="psub"):
    return (control["area"].reshape(*shape_fluid, -1),
            control[flow_key].reshape(*shape_fluid, 1),
            control["psup"].reshape(*shape_fluid, 1))


def _separation_mask(s: torch.Tensor, idx_sep: int) -> torch.Tensor:
    """1 up to and including ``idx_sep`` along each channel, 0 after: built
    once, on the residual's device."""
    f = torch.ones_like(s)
    f[..., idx_sep + 1:] = 0.0
    return f


def _floored(area):
    # the floor is filled on the area's device: no host copy, so a
    # captured step graph can hold it
    return torch.maximum(area, torch.full_like(area, AREA_FLOOR))


def _proto_args(n_fluid, n_total, flow_key="psub", **props):
    """The prototype (state, control, prop) of a residual: ones, and each
    further property at its given fill, in the JAX package's key order."""
    state = {"q": np.ones(n_fluid), "p": np.ones(n_total)}
    control = {"area": np.ones(n_total), flow_key: np.ones(n_fluid),
               "psup": np.ones(n_fluid)}
    prop = {"rho_air": np.ones(n_fluid),
            **{k: np.full(n_fluid, v) for k, v in props.items()}}
    return state, control, prop


class BernoulliFixedSep(PredefinedFluidResidual):
    """Hard separation at the fixed index ``idx_sep`` of each channel: the
    pressure is Bernoulli's up to it and ``psup`` after it."""

    def _make_residual(self, s: torch.Tensor, idx_sep: int = 0):
        shape_fluid, n_fluid, n_total = _shapes(s)
        f = _separation_mask(s, idx_sep)

        def res(state, control, prop):
            q, p = _reshape_qp_state(shape_fluid, state)
            area, psub, psup = _reshape_control(shape_fluid, control)
            rho = prop["rho_air"].reshape(*shape_fluid, 1)
            area = _floored(area)
            area_sep = area[..., idx_sep:idx_sep + 1]
            q_ = bernoulliq_from_psub_psep(psub, psup, math.inf, area_sep, rho)
            p_ = bernoullip_from_q_psep(q_, psup, area_sep, area, rho)
            p_ = f * p_ + (1 - f) * psup
            return {"q": (q - q_).reshape(-1), "p": (p - p_).reshape(-1)}

        return res, _proto_args(n_fluid, n_total)


class BernoulliFlowFixedSep(PredefinedFluidResidual):
    """Prescribed flow ``qsub`` with separation at the fixed index
    ``idx_sep``: the flow-driven variant."""

    def _make_residual(self, s: torch.Tensor, idx_sep: int = 0):
        shape_fluid, n_fluid, n_total = _shapes(s)
        f = _separation_mask(s, idx_sep)

        def res(state, control, prop):
            q, p = _reshape_qp_state(shape_fluid, state)
            area, qsub, psup = _reshape_control(shape_fluid, control, "qsub")
            rho = prop["rho_air"].reshape(*shape_fluid, 1)
            area = _floored(area)
            area_sep = area[..., idx_sep:idx_sep + 1]
            p_ = bernoullip_from_q_psep(qsub, psup, area_sep, area, rho)
            p_ = f * p_ + (1 - f) * psup
            return {"q": (q - qsub).reshape(-1), "p": (p - p_).reshape(-1)}

        return res, _proto_args(n_fluid, n_total, "qsub")


class BernoulliAreaRatioSep(PredefinedFluidResidual):
    """Separation where the area first exceeds ``r_sep * a_min`` downstream
    of the minimum.  Forward-exact but non-smooth (argmin-style masks)."""

    def _make_residual(self, s: torch.Tensor):
        shape_fluid, n_fluid, n_total = _shapes(s)

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
            q, p = _reshape_qp_state(shape_fluid, state)
            area, psub, psup = _reshape_control(shape_fluid, control)
            rho, r_sep, area_lb = (prop[k].reshape(*shape_fluid, 1)
                                   for k in ("rho_air", "r_sep", "area_lb"))
            q_, p_ = bernoulli_qp(area, psub, psup, rho, r_sep, area_lb)
            return {"q": (q - q_).reshape(-1), "p": (p - p_).reshape(-1)}

        return res, _proto_args(n_fluid, n_total, r_sep=1.0, area_lb=0.0)


class BernoulliSmoothMinSep(PredefinedFluidResidual):
    """Softmax smooth-min area and a sigmoid separation cut-off: fully
    differentiable (``vf_fem_tpu.residuals.fluid.BernoulliSmoothMinSep``,
    each of ``zeta_min``, ``zeta_sep`` its own property)."""

    def _make_residual(self, s: torch.Tensor):
        shape_fluid, n_fluid, n_total = _shapes(s)

        def bernoulli_qp(area, psub, psup, rho, zeta_min, zeta_sep):
            area = _floored(area)
            wmin = smooth_min_weight(area, zeta_min, axis=-1)
            amin = wavg(s, area, wmin, axis=-1)[..., None]
            smin = wavg(s, s * torch.ones_like(area), wmin, axis=-1)[..., None]
            q = bernoulliq_from_psub_psep(psub, psup, math.inf, amin, rho)
            p = bernoullip_from_q_psep(q, psup, amin, area, rho)
            return q, torch.sigmoid(-(s - smin) / zeta_sep) * p

        def res(state, control, prop):
            q, p = _reshape_qp_state(shape_fluid, state)
            area, psub, psup = _reshape_control(shape_fluid, control)
            rho, zeta_min, zeta_sep = (prop[k].reshape(*shape_fluid, 1)
                                       for k in ("rho_air", "zeta_min", "zeta_sep"))
            q_, p_ = bernoulli_qp(area, psub, psup, rho, zeta_min, zeta_sep)
            return {"q": (q - q_).reshape(-1), "p": (p - p_).reshape(-1)}

        return res, _proto_args(n_fluid, n_total, zeta_sep=1.0, zeta_min=1.0)
