"""
Per-step residual functionals (counterpart of
``vf_fem_tpu.stepfunctional.base``).
"""

from __future__ import annotations

import torch

from ..convert import to_tensors


def make_residuals(model):
    """A function mapping ``(state1, state0, control, prop, dt)`` (dicts of
    arrays or tensors, a float step) to the norm of each block of the
    model's step residual (``model.res_pure``): the per-block step
    residual diagnostics."""

    def residuals(state1, state0, control, prop, dt):
        dev, dtype = model.device, model.dtype
        with torch.no_grad():
            res = model.res_pure(*(to_tensors(d, dev, dtype)
                                   for d in (state1, state0, control, prop)), dt)
        return {k: float(torch.linalg.vector_norm(v)) for k, v in res.items()}

    return residuals
