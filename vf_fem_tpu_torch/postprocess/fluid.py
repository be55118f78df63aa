"""
Fluid measures (counterpart of ``vf_fem_tpu.postprocess.fluid``).
"""

from __future__ import annotations

import torch

from .base import BaseStateMeasure


class BaseFluidMeasure(BaseStateMeasure):
    pass


class FlowRate(BaseFluidMeasure):
    """Glottal flow rate q."""

    def assem_pure(self, state, control, prop):
        return state["q"]


class PressureField(BaseFluidMeasure):
    """1D channel pressure distribution p(s)."""

    def assem_pure(self, state, control, prop):
        return state["p"]


class MinArea(BaseFluidMeasure):
    """Minimum channel area of the control."""

    def assem_pure(self, state, control, prop):
        return torch.min(control["area"])
