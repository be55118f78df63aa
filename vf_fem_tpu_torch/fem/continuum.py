"""
Continuum-mechanics operators on batched tensors (counterpart of
``vf_fem_tpu.fem.continuum``).  They act on displacement gradients, which
are constant per P1 element; 2D tensors are padded to 3x3 (plane strain)
so that scalar invariants match the 3D forms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from .elements import det2, inv2


def pad_to_3x3(A: torch.Tensor) -> torch.Tensor:
    """Embed a (..., d, d) tensor into the upper-left of a 3x3 zero tensor."""
    d = A.shape[-1]
    return A if d == 3 else nnf.pad(A, (0, 3 - d, 0, 3 - d))


def strain_inf(grad_u: torch.Tensor) -> torch.Tensor:
    """Infinitesimal strain, padded to 3x3."""
    return pad_to_3x3(0.5 * (grad_u + grad_u.transpose(-1, -2)))


def def_grad(grad_u: torch.Tensor) -> torch.Tensor:
    """Deformation gradient F = I + grad(u), padded to 3x3."""
    eye = torch.eye(3, dtype=grad_u.dtype, device=grad_u.device)
    return pad_to_3x3(grad_u) + eye


def def_cauchy_green(grad_u: torch.Tensor) -> torch.Tensor:
    """Right Cauchy-Green tensor C = F^T F, 3x3."""
    F = def_grad(grad_u)
    return F.transpose(-1, -2) @ F


def strain_green_lagrange(grad_u: torch.Tensor) -> torch.Tensor:
    """Green-Lagrange strain E = (C - I)/2, 3x3."""
    eye = torch.eye(3, dtype=grad_u.dtype, device=grad_u.device)
    return 0.5 * (def_cauchy_green(grad_u) - eye)


def stress_isotropic(strain: torch.Tensor, emod, nu) -> torch.Tensor:
    """Linear isotropic stress from (E, nu); ``emod``/``nu`` carry the
    batch dimensions of ``strain`` without its two matrix axes."""
    lame_lambda = emod * nu / (1 + nu) / (1 - 2 * nu)
    lame_mu = emod / 2 / (1 + nu)
    d = strain.shape[-1]
    tr = sum(strain[..., i, i] for i in range(d))
    eye = torch.eye(d, dtype=strain.dtype, device=strain.device)
    return (
        2 * lame_mu[..., None, None] * strain
        + (lame_lambda * tr)[..., None, None] * eye
    )


def pullback_area_normal(grad_u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Nanson pullback cof(F) @ n = det(F) F^-T n, in 2D.

    ``grad_u`` (..., 2, 2); ``n`` (..., 2) reference facet normal."""
    eye = torch.eye(2, dtype=grad_u.dtype, device=grad_u.device)
    F = grad_u + eye
    detF = det2(F)
    Finv = inv2(F)
    return detF[..., None] * torch.einsum("...ji,...j->...i", Finv, n)


def positive_gap(gap: torch.Tensor) -> torch.Tensor:
    """Macaulay bracket <gap>."""
    return torch.clamp(gap, min=0.0)


def pressure_contact_cubic_penalty(gap, kcoll):
    """Cubic penalty contact pressure ``kcoll <gap>^3``."""
    return kcoll * positive_gap(gap) ** 3


def dform_cubic_penalty_pressure(gap, kcoll):
    """The contact pressure's derivative in the gap and ``<gap>^3``."""
    pg = positive_gap(gap)
    return kcoll * 3 * pg**2 * torch.sign(gap), pg**3
