"""
P1 triangle geometry and quadrature on batched tensors.

Counterpart of ``vf_fem_tpu.fem.elements``.  Every function takes tensors
with arbitrary leading batch dimensions (``...``): the assembly calls them
on all elements at once, and ``torch.func.vmap(torch.func.jacfwd(...))``
calls the same code on one element (no batch dimension) to build element
Jacobians.  Only 2D meshes (triangles) are on the port's path so far.
"""

from __future__ import annotations

import numpy as np
import torch

# -- Quadrature rules (barycentric coordinates, weights sum to 1) -----------

# Triangle, degree-2 exact (3 interior points)
TRI_QP = np.array(
    [
        [2 / 3, 1 / 6, 1 / 6],
        [1 / 6, 2 / 3, 1 / 6],
        [1 / 6, 1 / 6, 2 / 3],
    ]
)
TRI_QW = np.array([1 / 3, 1 / 3, 1 / 3])

# Interval (2D facet), 2-point Gauss (degree-3 exact)
_G = 0.5 / np.sqrt(3.0)
EDGE_QP = np.array([[0.5 + _G, 0.5 - _G], [0.5 - _G, 0.5 + _G]])
EDGE_QW = np.array([0.5, 0.5])


def _require_2d(dim: int) -> None:
    if dim != 2:
        raise NotImplementedError(
            f"the port supports 2D (triangle) meshes only, got dim={dim}"
        )


def cell_quadrature(dim: int):
    """(barycentric points, weights) for the cell of dimension ``dim``."""
    _require_2d(dim)
    return TRI_QP, TRI_QW


def facet_quadrature(dim: int):
    """(barycentric points, weights) for a facet of a ``dim``-cell."""
    _require_2d(dim)
    return EDGE_QP, EDGE_QW


# -- Element geometry ---------------------------------------------------------


def det2(A):
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A):
    d = det2(A)
    adj = torch.stack(
        [
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    )
    return adj / d[..., None, None]


def cell_shape_gradients(X_e: torch.Tensor):
    """(grads, volume) of a P1 triangle with vertices ``X_e`` (..., 3, 2).

    ``grads`` (..., 3, 2) holds the constant gradient of each barycentric
    shape function; ``volume`` (...) is the absolute cell area."""
    _require_2d(X_e.shape[-1])
    # D[i, j] = component i of edge vector j
    D = (X_e[..., 1:, :] - X_e[..., :1, :]).transpose(-1, -2)
    vol = torch.abs(det2(D)) / 2.0
    Dinv = inv2(D)  # rows are grad(lambda_i), i = 1, 2
    grad0 = -(Dinv[..., 0, :] + Dinv[..., 1, :])
    grads = torch.cat([grad0[..., None, :], Dinv], dim=-2)
    return grads, vol


def facet_measure_normal(Xf: torch.Tensor, X_opp: torch.Tensor):
    """(length, outward unit normal) of a boundary edge.

    ``Xf`` (..., 2, 2): the edge's vertex coordinates; ``X_opp`` (..., 2):
    the adjacent cell's remaining vertex, which orients the normal."""
    t = Xf[..., 1, :] - Xf[..., 0, :]
    length = torch.sqrt(t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1])
    n = torch.stack([t[..., 1], -t[..., 0]], dim=-1) / length[..., None]
    to_opp = X_opp - Xf[..., 0, :]
    inward = (n * to_opp).sum(-1) > 0
    n = torch.where(inward[..., None], -n, n)
    return length, n


def smallmat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for batches of tiny matrices (..., m, k) x (..., k, n)."""
    return torch.matmul(a, b)


def interp(values_e: torch.Tensor, bary: torch.Tensor):
    """Nodal values (..., nv, c) at barycentric points ``bary`` (nq, nv)
    -> (..., nq, c)."""
    return torch.einsum("qv,...vc->...qc", bary, values_e)
