"""
Newmark-beta time discretization (gamma=1/2, beta=1/4 by default).

The same closed-form relations as ``vf_fem_tpu.equations.newmark``,
written as dtype-agnostic arithmetic on tensors.  Each relation multiplies
by the step's coefficients (:func:`coefficients`): Python floats formed
from ``dt``, or 0-d tensors read from a coefficient table on the device
(the captured time step, ``forward``), which multiply to the same bits.
:func:`coefficient_rows` gives a run's rows as a differentiable function
of its step sizes (the gradient path, ``adjoint``).
"""

import numpy as np
import torch

NCOEFS = 8  # entries of a coefficient row


def coefficients(dt, dt_next=None, gamma=1 / 2, beta=1 / 4):
    """The eight coefficients of one step as Python floats, in double by the
    expressions the relations below have always multiplied by:
    ``(c1, c2, c3, c4, c5, dt, dtp, c)`` with c1 = gamma/beta/dt,
    c2 = gamma/beta - 1, c3 = dt (gamma/2/beta - 1), c4 = 1/beta/dt^2,
    c5 = 1/2/beta - 1, and the next step's predictor ``dtp = dt_next`` (by
    default ``dt``) with c = dtp^2/2.  Kernel K5 reads them in this order
    (``csrc/ops.cu``: NewmarkCoefs)."""
    dtp = dt if dt_next is None else dt_next
    return (gamma / beta / dt, gamma / beta - 1.0, dt * (gamma / 2.0 / beta - 1.0),
            1 / beta / dt**2, 1 / 2 / beta - 1, dt, dtp, 0.5 * dtp * dtp)


def coefficient_table(dts: np.ndarray, gamma=1 / 2, beta=1 / 4) -> np.ndarray:
    """(n_steps, 8) float64: row n holds the coefficients of step n and the
    predictor of step n + 1 (the last step's predictor takes its own dt),
    the rows the eager loop's Python floats give."""
    n = len(dts)
    return np.array([coefficients(float(dts[i]), float(dts[min(i + 1, n - 1)]),
                                  gamma, beta) for i in range(n)], dtype=np.float64)


def coefficient_rows(dts: torch.Tensor, gamma=1 / 2, beta=1 / 4) -> torch.Tensor:
    """The (n, 8) float64 rows of a run's steps ``dts`` (a float64 tensor,
    which may require grad): row n holds step n's coefficients and the
    predictor of step n + 1 (the last step's its own), as
    :func:`coefficient_table` gives them.  Their values are the Python
    floats' bits (formed from ``dts`` on the host in double), so a step that
    multiplies by them gives the float steps' results; their derivatives
    with respect to ``dts`` are those of the closed forms, added as
    ``g - g.detach()`` (zero in value)."""
    values = torch.as_tensor(
        coefficient_table(dts.detach().cpu().numpy(), gamma, beta), device=dts.device)
    dtp = torch.cat([dts[1:], dts[-1:]])
    one = torch.ones_like(dts)
    forms = torch.stack([
        one * (gamma / beta) / dts, one * (gamma / beta - 1.0),
        dts * (gamma / 2.0 / beta - 1.0), one * (1 / beta) / (dts * dts),
        one * (1 / 2 / beta - 1), dts, dtp, 0.5 * dtp * dtp,
    ], dim=1)
    return values + (forms - forms.detach())


def predict_k(u0, v0, a0, k):
    """The predictor ``u0 + dtp v0 + c a0`` of coefficients ``k``."""
    return u0 + k[6] * v0 + k[7] * a0


def velocity_k(u, u0, v0, a0, k):
    """Velocity update ``c1 (u - u0) - c2 v0 - c3 a0``."""
    return k[0] * (u - u0) - k[1] * v0 - k[2] * a0


def acceleration_k(u, u0, v0, a0, k):
    """Acceleration update ``c4 (u - u0 - dt v0) - c5 a0``."""
    return k[3] * (u - u0 - k[5] * v0) - k[4] * a0


def newmark_predict_u(u0, v0, a0, dt):
    """Explicit Newmark predictor u0 + dt*v0 + dt^2/2 * a0: the starting
    guess of the implicit displacement solve."""
    return predict_k(u0, v0, a0, coefficients(dt))


def newmark_v(u, u0, v0, a0, dt, gamma=1 / 2, beta=1 / 4):
    """Velocity update."""
    return velocity_k(u, u0, v0, a0, coefficients(dt, gamma=gamma, beta=beta))


def newmark_a(u, u0, v0, a0, dt, gamma=1 / 2, beta=1 / 4):
    """Acceleration update."""
    return acceleration_k(u, u0, v0, a0, coefficients(dt, gamma=gamma, beta=beta))
