"""
Linear solves of the Newmark Jacobian (counterpart of
``vf_fem_tpu.solvers.linalg``): dense solves on ``torch.linalg`` (and
their transposes, for the adjoint), and the
matrix-free Krylov solvers (``pcg``, ``bicgstab``) of the ``cg``/``bsb``
paths.

Newmark Jacobians mix mass terms ~ rho/(beta dt^2) (~1e8 at dt=1e-4) with
traction rows ~ O(1); symmetric Jacobi equilibration ``D^-1/2 A D^-1/2``
keeps f32 solves accurate and is harmless in f64.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def _equilibrate(A: torch.Tensor) -> torch.Tensor:
    """Symmetric Jacobi equilibration scale: d = sqrt(|diag A|)."""
    return torch.sqrt(torch.abs(torch.diagonal(A)) + 1e-30)


def dense_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = _equilibrate(A)
    As = A / d[:, None] / d[None, :]
    y = torch.linalg.solve(As, b / d)
    return y / d


def dense_solve_transpose(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A^T x = b`` with the same symmetric equilibration as
    :func:`dense_solve` (the adjoint solve of a step's IFT rule)."""
    d = _equilibrate(A)
    As = A / d[:, None] / d[None, :]
    y = torch.linalg.solve(As.mT, b / d)
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


def dense_factor_solve_t(factors, b: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`dense_factor_solve`: ``(Ainv^T (b/d))/d``,
    carried factors applied as a transposed preconditioner."""
    Ainv, d = factors
    return (Ainv.mT @ (b / d)) / d


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


# -- Krylov solvers -------------------------------------------------------------
#
# The recurrences and stopping rule of ``vf_fem_tpu.solvers.linalg.pcg`` /
# ``bicgstab``, from x = 0: iterate while ``||r|| > max(tol ||b||, ATOL)``
# and fewer than ``max_iter`` iterations ran.  The JAX package tests that
# condition inside a ``while_loop`` on the device; here each test reads
# ``||r||`` on the host, one synchronisation per iteration (``n_iter + 1``
# per solve).

ATOL = 1e-12


class CGResult(NamedTuple):
    x: torch.Tensor
    n_iter: int
    res_norm: torch.Tensor


def _target(b: torch.Tensor, tol: float) -> float:
    return max(tol * float(torch.linalg.vector_norm(b)), ATOL)


def pcg(matvec: Callable, b: torch.Tensor, precond: Callable,
        tol: float = 1e-10, max_iter: int = 1000) -> CGResult:
    """Preconditioned conjugate gradients (``precond(r)`` applies the
    inverse of the preconditioner)."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    target = _target(b, tol)
    k = 0
    while k < max_iter and float(torch.linalg.vector_norm(r)) > target:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return CGResult(x=x, n_iter=k, res_norm=torch.linalg.vector_norm(r))


def bicgstab(matvec: Callable, b: torch.Tensor, precond: Callable,
             tol: float = 1e-10, max_iter: int = 1000) -> CGResult:
    """Preconditioned BiCGStab (the Newmark Jacobian is nonsymmetric
    through the follower-pressure surface terms); zero denominators are
    replaced by 1e-30 as in the JAX package."""
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r
    target = _target(b, tol)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    def safe(d):
        return torch.where(d == 0, eps, d)

    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while k < max_iter and float(torch.linalg.vector_norm(r)) > target:
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_new / safe(torch.dot(rhat, v))
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        omega = torch.dot(t, s) / safe(torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return CGResult(x=x, n_iter=k, res_norm=torch.linalg.vector_norm(r))
