"""
Dense linear solves of the Newmark Jacobian on ``torch.linalg``
(counterpart of ``vf_fem_tpu.solvers.linalg``, dense part).

Newmark Jacobians mix mass terms ~ rho/(beta dt^2) (~1e8 at dt=1e-4) with
traction rows ~ O(1); symmetric Jacobi equilibration ``D^-1/2 A D^-1/2``
keeps f32 solves accurate and is harmless in f64.
"""

from __future__ import annotations

import torch


def _equilibrate(A: torch.Tensor) -> torch.Tensor:
    """Symmetric Jacobi equilibration scale: d = sqrt(|diag A|)."""
    return torch.sqrt(torch.abs(torch.diagonal(A)) + 1e-30)


def dense_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = _equilibrate(A)
    As = A / d[:, None] / d[None, :]
    y = torch.linalg.solve(As, b / d)
    return y / d


def dense_factor(A: torch.Tensor):
    """Equilibrate and invert once; reuse with :func:`dense_factor_solve`
    (a frozen-Jacobian Newton iteration is then one matvec)."""
    d = _equilibrate(A)
    As = A / d[:, None] / d[None, :]
    eye = torch.eye(As.shape[0], dtype=As.dtype, device=As.device)
    return (torch.linalg.solve(As, eye), d)


def dense_factor_solve(factors, b: torch.Tensor) -> torch.Tensor:
    Ainv, d = factors
    return (Ainv @ (b / d)) / d


def dense_refresh(factors, A: torch.Tensor, iters: int = 2):
    """Newton-Schulz update ``X <- X + X(I - A X)`` of a carried explicit
    inverse toward the current Jacobian ``A``: two matmuls per sweep, each
    squaring the error ``||I - A X||`` while it is below 1."""
    d = _equilibrate(A)
    As = A / d[:, None] / d[None, :]
    X, d_old = factors
    # re-express the old scaled inverse in the new equilibration
    s = d / d_old
    X = X * s[:, None] * s[None, :]
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        X = X + X @ (eye - As @ X)
    return (X, d)
