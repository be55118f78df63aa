"""
Smooth approximation functions for separation-point models (counterpart
of ``vf_fem_tpu.equations.smoothapprox``).
"""

import torch


def trapezoid(y, x, axis=-1):
    """Trapezoid-rule integral of samples y(x) along ``axis``."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    n = y.shape[axis]
    dx = torch.diff(x, dim=axis)
    y0 = y.narrow(axis, 0, n - 1)
    y1 = y.narrow(axis, 1, n - 1)
    return torch.sum(0.5 * dx * (y0 + y1), dim=axis)


def wavg(s, f, w, axis=-1):
    """Weighted average of f(s) with weights w(s)."""
    return trapezoid(f * w, s, axis=axis) / trapezoid(w, s, axis=axis)


def smooth_min_weight(f, zeta=1, axis=-1):
    """Softmax weights selecting the smooth minimum of f."""
    return torch.softmax(-f / zeta, dim=axis)
