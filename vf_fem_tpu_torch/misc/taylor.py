"""
Taylor-convergence test utility (a copy of ``vf_fem_tpu.misc.taylor``,
which imports only numpy; tensors are taken as numpy arrays).

Checks that a claimed linearization ``jac`` of ``f`` is consistent:
``|f(x0 + h dx) - f(x0) - h jac(x0, dx)|`` must converge at order 2 in h.
This is the universal derivative-correctness check of the test suite
(SURVEY section 4).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _host(x):
    """A tensor as a numpy array; anything else as it is."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


def _norm(x) -> float:
    x = _host(x)
    if np.isscalar(x) or np.ndim(x) == 0:
        return abs(float(x))
    return float(np.linalg.norm(np.asarray(x)))


def taylor_convergence(
    x0,
    dx,
    f: Callable,
    jac: Callable,
    norm: Callable = _norm,
    ns: np.ndarray = None,
    conv_tol: float = 0.1,
    abs_tol: float = 1e-10,
    rel_tol: float = 1e-8,
):
    """
    Assert second-order Taylor convergence of ``f`` against ``jac``.

    Parameters
    ----------
    x0, dx:
        Base point and perturbation direction (arrays or scalars).
    f:
        ``f(x)`` -> array/scalar.
    jac:
        ``jac(x, dx)`` -> directional derivative of f at x along dx.
    ns:
        Step exponents; step sizes are ``0.5**n``.

    Returns
    -------
    (errors, convergence_rates)
    """
    if ns is None:
        ns = np.arange(4)
    hs = 0.5 ** np.asarray(ns, dtype=float)

    f0 = np.asarray(_host(f(x0)))
    df = np.asarray(_host(jac(x0, dx)))

    errors = []
    res_norms = []
    for h in hs:
        f1 = np.asarray(_host(f(x0 + h * np.asarray(dx))))
        err = norm(f1 - f0 - h * df)
        errors.append(err)
        res_norms.append(norm(f1 - f0))
    errors = np.array(errors)
    res_norms = np.array(res_norms)

    # if the function is (numerically) linear, errors are ~0 and rates
    # meaningless: accept on absolute/relative smallness
    magnitude = max(norm(f0), float(np.max(res_norms)), 1e-30)
    if np.all(errors <= max(abs_tol, rel_tol * magnitude)):
        return errors, np.full(len(errors) - 1, np.nan)

    with np.errstate(divide="ignore", invalid="ignore"):
        rates = np.log2(errors[:-1] / errors[1:])
    # rates should approach 2 (second order)
    valid = np.isfinite(rates)
    if not np.any(valid):
        raise AssertionError(f"Taylor test degenerate: errors={errors}")
    if not np.any(np.abs(rates[valid] - 2.0) < 2.0 * conv_tol + 0.5):
        raise AssertionError(
            f"Taylor convergence rate not ~2: rates={rates}, errors={errors}"
        )
    return errors, rates
