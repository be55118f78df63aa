"""
Newton solver (counterpart of ``vf_fem_tpu.solvers.newton.newton_solve``).

Stopping rule: converged when ``abs_err < abs_tol`` or
``abs_err < rel_tol * abs_err0``; stop early when an iteration fails to
reduce the residual by ``stagnation_ratio`` (the rounding-noise floor of
reduced precision) or at ``maximum_iterations``.  The lowest-residual
iterate seen is returned.

``fixed_iterations=n`` runs exactly n chord iterations with no host
synchronisation (the convergence telemetry stays on the device):
certified mode assembles a trailing residual and keeps the best iterate;
``fixed_tail_residual=False`` skips that residual and commits the final
iterate, reporting the penultimate residual.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..solverconst import DEFAULT_NEWTON_SOLVER_PRM


class SolveInfo(NamedTuple):
    num_iter: torch.Tensor
    abs_err: torch.Tensor
    rel_err: torch.Tensor


def _rel(err, err0):
    return err / torch.where(err0 == 0, 1.0, err0)


def newton_solve(
    x0: torch.Tensor,
    assem_res: Callable[[torch.Tensor], torch.Tensor],
    solve_jac: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    params: dict = None,
):
    """Solve ``assem_res(x) = 0``; ``solve_jac(x, r)`` returns
    ``J(x)^{-1} r`` (or an approximation of it)."""
    params = {**DEFAULT_NEWTON_SOLVER_PRM, **(params or {})}
    abs_tol = params["absolute_tolerance"]
    rel_tol = params["relative_tolerance"]
    max_iter = params["maximum_iterations"]
    norm = torch.linalg.vector_norm

    n_fixed = params.get("fixed_iterations")
    if n_fixed:
        n_fixed = int(n_fixed)
        num_iter = torch.tensor(n_fixed, device=x0.device)
        x = x0
        res = assem_res(x)
        err0 = norm(res)
        # fixed-1 has no penultimate iterate: it always takes the
        # certified path
        if n_fixed >= 2 and not params.get("fixed_tail_residual", True):
            err_pen = err0
            for i in range(n_fixed):
                x = x - solve_jac(x, res)
                if i + 1 < n_fixed:
                    res = assem_res(x)
                    err_pen = norm(res)
            return x, SolveInfo(num_iter, err_pen, _rel(err_pen, err0))
        x_best, err_best = x, err0
        for _ in range(n_fixed):
            x = x - solve_jac(x, res)
            res = assem_res(x)
            err = norm(res)
            better = err < err_best
            x_best = torch.where(better, x, x_best)
            err_best = torch.where(better, err, err_best)
        return x_best, SolveInfo(num_iter, err_best, _rel(err_best, err0))

    stagnation_ratio = params.get("stagnation_ratio", 0.9)
    res = assem_res(x0)
    err0_t = norm(res)
    err0 = float(err0_t)
    # finite sentinel for the first progress test
    err_prev = float(torch.finfo(err0_t.dtype).max) * 0.125
    x = x_best = x0
    err = err_best = err0
    err_best_t = err0_t
    k = 0
    while (
        err >= abs_tol
        and err >= rel_tol * err0
        and err < stagnation_ratio * err_prev
        and k < max_iter
    ):
        x = x - solve_jac(x, res)
        res = assem_res(x)
        err_t = norm(res)
        err_prev, err = err, float(err_t)
        # with an approximate Jacobian an iteration can overshoot: keep the
        # lowest-residual iterate, not the last
        if err < err_best:
            x_best, err_best, err_best_t = x, err, err_t
        k += 1
    num_iter = torch.tensor(k, device=x0.device)
    return x_best, SolveInfo(num_iter, err_best_t, _rel(err_best_t, err0_t))
