"""
P1 simplex (triangle and tetrahedron) geometry and quadrature on batched
tensors.

Counterpart of ``vf_fem_tpu.fem.elements``.  Every function takes tensors
with arbitrary leading batch dimensions (``...``): the assembly calls them
on all elements at once, and ``torch.func.vmap(torch.func.jacfwd(...))``
calls the same code on one element (no batch dimension) to build element
Jacobians.  Determinants and inverses are the closed (cofactor) forms.
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

# Tetrahedron, degree-2 exact (4 points)
_TET_A = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
_TET_B = (5.0 - np.sqrt(5.0)) / 20.0
TET_QP = np.array(
    [
        [_TET_A, _TET_B, _TET_B, _TET_B],
        [_TET_B, _TET_A, _TET_B, _TET_B],
        [_TET_B, _TET_B, _TET_A, _TET_B],
        [_TET_B, _TET_B, _TET_B, _TET_A],
    ]
)
TET_QW = np.array([0.25, 0.25, 0.25, 0.25])

# Interval (2D facet), 2-point Gauss (degree-3 exact)
_G = 0.5 / np.sqrt(3.0)
EDGE_QP = np.array([[0.5 + _G, 0.5 - _G], [0.5 - _G, 0.5 + _G]])
EDGE_QW = np.array([0.5, 0.5])

# Triangle facet of a tetrahedron: TRI_QP / TRI_QW.


def cell_quadrature(dim: int):
    """(barycentric points, weights) for the cell of dimension ``dim``."""
    if dim == 2:
        return TRI_QP, TRI_QW
    if dim == 3:
        return TET_QP, TET_QW
    raise ValueError(f"Unsupported cell dimension {dim}")


def facet_quadrature(dim: int):
    """(barycentric points, weights) for a facet of a ``dim``-cell."""
    if dim == 2:
        return EDGE_QP, EDGE_QW
    if dim == 3:
        return TRI_QP, TRI_QW
    raise ValueError(f"Unsupported cell dimension {dim}")


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


def det3(A):
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def inv3(A):
    """Inverse of (..., 3, 3) by the adjugate over the determinant."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det3(A)[..., None, None]


def det_small(A):
    """Determinant of a (..., d, d) matrix, d in {2, 3}, closed form."""
    return det2(A) if A.shape[-1] == 2 else det3(A)


def inv_small(A):
    """Inverse of a (..., d, d) matrix, d in {2, 3}, closed form."""
    return inv2(A) if A.shape[-1] == 2 else inv3(A)


def cell_shape_gradients(X_e: torch.Tensor):
    """(grads, volume) of a P1 simplex with vertices ``X_e`` (..., nv, dim).

    ``grads`` (..., nv, dim) holds the constant gradient of each barycentric
    shape function; ``volume`` (...) is the absolute cell measure."""
    dim = X_e.shape[-1]
    # D[i, j] = component i of edge vector j
    D = (X_e[..., 1:, :] - X_e[..., :1, :]).transpose(-1, -2)
    vol = torch.abs(det_small(D)) / (2.0 if dim == 2 else 6.0)
    Dinv = inv_small(D)  # rows are grad(lambda_i), i = 1 .. dim
    grad0 = -sum(Dinv[..., k, :] for k in range(dim))
    grads = torch.cat([grad0[..., None, :], Dinv], dim=-2)
    return grads, vol


def facet_measure_normal(Xf: torch.Tensor, X_opp: torch.Tensor):
    """(measure, outward unit normal) of a boundary facet.

    ``Xf`` (..., dim, dim): the facet's vertex coordinates (an edge in 2D,
    a triangle in 3D); ``X_opp`` (..., dim): the adjacent cell's remaining
    vertex, which orients the normal."""
    if Xf.shape[-1] == 2:
        t = Xf[..., 1, :] - Xf[..., 0, :]
        meas = torch.sqrt(t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1])
        n = torch.stack([t[..., 1], -t[..., 0]], dim=-1) / meas[..., None]
    else:
        c = torch.linalg.cross(Xf[..., 1, :] - Xf[..., 0, :],
                               Xf[..., 2, :] - Xf[..., 0, :])
        nc = torch.sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
                        + c[..., 2] * c[..., 2])
        n = c / nc[..., None]
        meas = 0.5 * nc
    to_opp = X_opp - Xf[..., 0, :]
    inward = (n * to_opp).sum(-1) > 0
    n = torch.where(inward[..., None], -n, n)
    return meas, n


def smallmat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for batches of tiny matrices (..., m, k) x (..., k, n)."""
    return torch.matmul(a, b)


def interp(values_e: torch.Tensor, bary: torch.Tensor):
    """Nodal values (..., nv, c) at barycentric points ``bary`` (nq, nv)
    -> (..., nq, c)."""
    return torch.einsum("qv,...vc->...qc", bary, values_e)
