"""
Newmark-beta time discretization (gamma=1/2, beta=1/4 by default).

The same closed-form relations as ``vf_fem_tpu.equations.newmark``,
written as dtype-agnostic arithmetic on tensors (``dt`` is a Python float).
"""


def newmark_predict_u(u0, v0, a0, dt):
    """Explicit Newmark predictor u0 + dt*v0 + dt^2/2 * a0: the starting
    guess of the implicit displacement solve."""
    return u0 + dt * v0 + 0.5 * dt * dt * a0


def newmark_v(u, u0, v0, a0, dt, gamma=1 / 2, beta=1 / 4):
    """Velocity update."""
    return (
        gamma / beta / dt * (u - u0)
        - (gamma / beta - 1.0) * v0
        - dt * (gamma / 2.0 / beta - 1.0) * a0
    )


def newmark_a(u, u0, v0, a0, dt, gamma=1 / 2, beta=1 / 4):
    """Acceleration update."""
    return 1 / beta / dt**2 * (u - u0 - dt * v0) - (1 / 2 / beta - 1) * a0
