"""
The solid forms on the port's path, as batched element kernels.

Counterpart of ``vf_fem_tpu.fem.forms``: each form class maps the element's
geometry and local coefficient values to that element's residual
contribution.  Kernels take tensors with leading batch dimensions
(``...``), so one call covers every element, and the same code under
``torch.func.vmap(torch.func.jacfwd(...))`` gives element Jacobians.

Local coefficient layout (after the gather):
- ``cg1_vector``: (..., nv, dim); ``cg1_scalar``: (..., nv)
- ``dg0_scalar``: (...); ``const_scalar``: (); ``const_vector``: (dim,)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as nnf

from .continuum import pullback_area_normal, strain_inf, stress_isotropic
from .elements import interp


# -- Coefficient specs --------------------------------------------------------


@dataclass(frozen=True)
class CoeffSpec:
    space: str  # cg1_vector | cg1_scalar | dg0_scalar | const_scalar | const_vector
    default: float = 0.0


def cg1_vector(default=0.0):
    return CoeffSpec("cg1_vector", default)


def cg1_scalar(default=0.0):
    return CoeffSpec("cg1_scalar", default)


def dg0_scalar(default=0.0):
    return CoeffSpec("dg0_scalar", default)


def const_scalar(default=0.0):
    return CoeffSpec("const_scalar", default)


def const_vector(default=0.0):
    return CoeffSpec("const_vector", default)


# -- Element geometry contexts ------------------------------------------------


class CellGeom(NamedTuple):
    X: torch.Tensor  # (..., nv, dim) vertex coords
    grads: torch.Tensor  # (..., nv, dim) shape-function gradients
    vol: torch.Tensor  # (...) cell measure
    bary: torch.Tensor  # (nq, nv) quadrature barycentric coords
    qw: torch.Tensor  # (nq,) quadrature weights (sum 1)


class FacetGeom(NamedTuple):
    """Facet geometry bound to its adjacent cell.  ``sel`` (..., nv, dimf)
    is the one-hot facet-vertex selector of the cell's local vertices."""

    X: torch.Tensor  # (..., nv, dim) adjacent-cell vertex coords
    grads: torch.Tensor  # (..., nv, dim) adjacent-cell shape gradients
    meas: torch.Tensor  # (...) facet measure
    normal: torch.Tensor  # (..., dim) outward unit facet normal
    fbary: torch.Tensor  # (nq, dimf) facet quadrature barycentric coords
    fqw: torch.Tensor  # (nq,) facet quadrature weights
    sel: torch.Tensor  # (..., nv, dimf) one-hot facet-vertex selector


def grad_field(field_e: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """Constant gradient of a P1 field: (..., nv, c) x (..., nv, d) ->
    (..., c, d)."""
    return torch.einsum("...vi,...vj->...ij", field_e, grads)


def _stress_residual(sigma3: torch.Tensor, geom: CellGeom) -> torch.Tensor:
    """vol * sigma : strain(test) for all (node, component) tests."""
    dim = geom.grads.shape[-1]
    rows = torch.einsum(
        "...vj,...ij->...vi", geom.grads, sigma3[..., :dim, :dim]
    )
    return geom.vol[..., None, None] * rows


def _force_residual(f_q: torch.Tensor, geom: CellGeom) -> torch.Tensor:
    """vol * sum_q w_q f(x_q) . test, for f_q (..., nq, dim)."""
    rows = torch.einsum("qk,q,...qc->...kc", geom.bary, geom.qw, f_q)
    return geom.vol[..., None, None] * rows


def facet_restrict(cell_nodal: torch.Tensor, sel: torch.Tensor):
    """Restrict cell nodal values (..., nv, c) to the facet's (..., dimf, c)."""
    return torch.einsum("...vd,...vc->...dc", sel, cell_nodal)


def _facet_force_residual(t_q: torch.Tensor, geom: FacetGeom) -> torch.Tensor:
    """Facet traction integral (t_q (..., nq, dim)) as cell-local nodal
    contributions (..., nv, dim)."""
    res_f = torch.einsum("qd,q,...qc->...dc", geom.fbary, geom.fqw, t_q)
    res_f = geom.meas[..., None, None] * res_f  # (..., dimf, dim)
    return torch.einsum("...vd,...dc->...vc", geom.sel, res_f)


def _membrane_rows(stress_pp: torch.Tensor, geom: FacetGeom) -> torch.Tensor:
    """grads . stress_pp for all cell-node tests: (..., nv, dim)."""
    dim = geom.grads.shape[-1]
    return torch.einsum(
        "...vj,...ij->...vi", geom.grads, stress_pp[..., :dim, :dim]
    )


# -- Form algebra -------------------------------------------------------------


class BaseForm:
    COEFFICIENT_SPEC: dict = {}
    domain = "cell"  # or 'facet'

    def cell_kernel(self, geom: CellGeom, local: dict) -> torch.Tensor:
        raise NotImplementedError

    def facet_kernel(self, geom: FacetGeom, local: dict) -> torch.Tensor:
        raise NotImplementedError


# -- Cell forms ---------------------------------------------------------------


class InertialForm(BaseForm):
    """rho * a . test."""

    COEFFICIENT_SPEC = {
        "state/a1": cg1_vector(),
        "prop/rho": dg0_scalar(1.0),
    }

    def cell_kernel(self, geom, local):
        a_q = interp(local["state/a1"], geom.bary)
        return _force_residual(local["prop/rho"][..., None, None] * a_q, geom)


class IsotropicElasticForm(BaseForm):
    """Linear isotropic elasticity."""

    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "state/v1": cg1_vector(),
        "prop/emod": dg0_scalar(1.0),
        "prop/nu": const_scalar(0.45),
    }

    def cell_kernel(self, geom, local):
        eps = strain_inf(grad_field(local["state/u1"], geom.grads))
        sigma = stress_isotropic(eps, local["prop/emod"], local["prop/nu"])
        return _stress_residual(sigma, geom)


class KelvinVoigtForm(BaseForm):
    """Kelvin-Voigt viscosity."""

    COEFFICIENT_SPEC = {
        "state/v1": cg1_vector(),
        "prop/eta": dg0_scalar(1.0),
    }

    def cell_kernel(self, geom, local):
        rate = strain_inf(grad_field(local["state/v1"], geom.grads))
        return _stress_residual(local["prop/eta"][..., None, None] * rate, geom)


# -- Facet forms --------------------------------------------------------------


class SurfacePressureForm(BaseForm):
    """Follower pressure load via the Nanson pullback of the facet normal."""

    domain = "facet"
    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "control/p1": cg1_scalar(),
    }

    def facet_kernel(self, geom: FacetGeom, local):
        grad_u = grad_field(local["state/u1"], geom.grads)
        pn = pullback_area_normal(grad_u, geom.normal)  # (..., dim)
        p_f = facet_restrict(local["control/p1"][..., None], geom.sel)
        p_q = interp(p_f, geom.fbary)  # (..., nq, 1)
        t_q = -p_q * pn[..., None, :]
        return _facet_force_residual(t_q, geom)


class ManualSurfaceContactTractionForm(BaseForm):
    """Surface integral of a nodal contact traction (the traction field is
    computed from the displacement by the model layer, so differentiating
    the residual through it gives the contact stiffness)."""

    domain = "facet"
    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "control/tcontact": cg1_vector(),
        "prop/ycontact": const_scalar(np.inf),
        "prop/ncontact": const_vector(),
        "prop/kcontact": const_scalar(1.0),
    }

    def facet_kernel(self, geom: FacetGeom, local):
        tc_f = facet_restrict(local["control/tcontact"], geom.sel)
        return _facet_force_residual(interp(tc_f, geom.fbary), geom)


class IsotropicMembraneForm(BaseForm):
    """Isotropic elastic membrane (epithelium) on the traction facets."""

    domain = "facet"
    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "prop/emod_membrane": dg0_scalar(0.0),
        "prop/nu_membrane": dg0_scalar(0.45),
        "prop/th_membrane": dg0_scalar(0.0),
    }

    def facet_kernel(self, geom: FacetGeom, local):
        dim = geom.X.shape[-1]
        eps = strain_inf(grad_field(local["state/u1"], geom.grads))
        n3 = nnf.pad(geom.normal, (0, 3 - dim))
        eye = torch.eye(3, dtype=eps.dtype, device=eps.device)
        P = eye - n3[..., :, None] * n3[..., None, :]
        eps_pp = P @ eps @ P
        emod = local["prop/emod_membrane"]
        nu = local["prop/nu_membrane"]
        mu = emod / 2 / (1 + nu)
        lmbda = emod * nu / (1 + nu) / (1 - 2 * nu)
        # plane-stress lambda, guarding the 0/0 at emod = 0
        denom = torch.where(emod == 0, 1.0, lmbda + 2 * mu)
        lmbda_pp = torch.where(emod == 0, 0.0, 2 * mu * lmbda / denom)
        tr_pp = eps_pp[..., 0, 0] + eps_pp[..., 1, 1] + eps_pp[..., 2, 2]
        stress_pp = (
            2 * mu[..., None, None] * eps_pp
            + (lmbda_pp * tr_pp)[..., None, None] * P
        )
        th = local["prop/th_membrane"]
        return (geom.meas * th)[..., None, None] * _membrane_rows(
            stress_pp, geom
        )
