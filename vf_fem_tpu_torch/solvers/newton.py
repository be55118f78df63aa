"""
Newton solver (counterpart of ``vf_fem_tpu.solvers.newton.newton_solve``).

Stopping rule: converged when ``abs_err < abs_tol`` or
``abs_err < rel_tol * abs_err0``; stop early when an iteration fails to
reduce the residual by ``stagnation_ratio`` (the rounding-noise floor of
reduced precision) or at ``maximum_iterations``.  The lowest-residual
iterate seen is returned.

``fixed_iterations=n`` runs exactly n chord iterations with no host
synchronisation and no host-to-device copy (the convergence telemetry
stays on the device), so a CUDA graph can capture it:
certified mode assembles a trailing residual and keeps the best iterate;
``fixed_tail_residual=False`` skips that residual and commits the final
iterate, reporting the penultimate residual.

:func:`iterative_solve` is the fixed-point (Picard) loop of the implicit
coupling, plain or with Aitken relaxation (counterpart of
``vf_fem_tpu.solvers.newton.iterative_solve``).
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
    norm_fn: Callable[[torch.Tensor], torch.Tensor] = None,
):
    """Solve ``assem_res(x) = 0``; ``solve_jac(x, r)`` returns
    ``J(x)^{-1} r`` (or an approximation of it).  ``norm_fn`` measures the
    residual (default the 2-norm; the DOF-sharded step passes the norm of a
    vector sharded over its shards, ``parallel.shards.pnorm``)."""
    params = {**DEFAULT_NEWTON_SOLVER_PRM, **(params or {})}
    abs_tol = params["absolute_tolerance"]
    rel_tol = params["relative_tolerance"]
    max_iter = params["maximum_iterations"]
    norm = norm_fn or torch.linalg.vector_norm

    n_fixed = params.get("fixed_iterations")
    if n_fixed:
        n_fixed = int(n_fixed)
        # a fill, not a host-to-device copy: the step stays capturable
        num_iter = torch.full((), n_fixed, dtype=torch.int64, device=x0.device)
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


def _leaves(tree: dict):
    """A dict's tensors in the JAX package's leaf order (sorted keys)."""
    return [tree[k] for k in sorted(tree)]


def tree_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves (sorted keys) of their sums of
    squares: the JAX package's default norm of ``iterative_solve``."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in _leaves(tree)))


def _tree_dot(a: dict, b: dict) -> torch.Tensor:
    return sum(torch.dot(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def iterative_solve(
    x0: dict,
    assem_res: Callable[[dict], dict],
    step: Callable[[dict], dict],
    params: dict = None,
):
    """Fixed-point (Picard) iteration ``x <- step(x)`` on a dict of tensors
    until the norm of ``assem_res(x)`` (:func:`tree_norm`) is below
    ``absolute_tolerance`` or ``relative_tolerance`` times its initial
    value (``DEFAULT_NEWTON_SOLVER_PRM`` where ``params`` has none; the
    implicit model passes ``FIXEDPOINT_SOLVER_PRM``), fails to fall below
    ``stagnation_ratio`` (default 0.98) times the previous one, or
    ``maximum_iterations`` ran.  Returns the **last**
    iterate (not the lowest-residual one, unlike :func:`newton_solve`) and
    its ``SolveInfo``.

    ``aitken=True`` relaxes each update, ``x <- x + w d`` with
    ``d = step(x) - x``: ``w = aitken_omega0`` (default 1) in the first
    iteration, then ``w = -w_prev <d_prev, d - d_prev> / |d - d_prev|^2``
    (``w_prev`` where the denominator is 0), clipped to [0.05, 2].  The loop
    is eager: one host read of the norm an iteration."""
    params = {**DEFAULT_NEWTON_SOLVER_PRM, **(params or {})}
    abs_tol = params["absolute_tolerance"]
    rel_tol = params["relative_tolerance"]
    max_iter = params.get("maximum_iterations", 50)
    stag = params.get("stagnation_ratio", 0.98)
    aitken = bool(params.get("aitken", False))

    err0_t = tree_norm(assem_res(x0))
    err0 = float(err0_t)
    x, err_t, err, err_prev = x0, err0_t, err0, float("inf")
    # the relaxation factor stays on the device, in the residual's dtype
    w = torch.full((), float(params.get("aitken_omega0", 1.0)), dtype=err0_t.dtype,
                   device=err0_t.device)
    d_prev = None
    k = 0
    while (err >= abs_tol and err >= rel_tol * err0 and err < stag * err_prev
           and k < max_iter):
        x_new = step(x)
        if aitken:
            d = {key: x_new[key] - x[key] for key in x}
            if d_prev is not None:
                dd = {key: d[key] - d_prev[key] for key in d}
                denom = _tree_dot(dd, dd)
                safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
                w = torch.where(denom > 0.0, -w * _tree_dot(d_prev, dd) / safe, w)
            w = torch.clamp(w, 0.05, 2.0)
            x_new = {key: x[key] + w * d[key] for key in x}
            d_prev = d
        x = x_new
        err_t = tree_norm(assem_res(x))
        err_prev, err = err, float(err_t)
        k += 1
    num_iter = torch.tensor(k, device=err0_t.device)
    return x, SolveInfo(num_iter, err_t, _rel(err_t, err0_t))
