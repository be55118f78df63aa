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

from .continuum import (
    def_grad,
    pullback_area_normal,
    strain_green_lagrange,
    strain_inf,
    stress_isotropic,
)
from .elements import interp, smallmat_mul


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


def _pk2_residual(S: torch.Tensor, F: torch.Tensor, geom: CellGeom) -> torch.Tensor:
    """vol * S : dE(test) with E the Green-Lagrange strain (PK2 weak form)."""
    return _stress_residual(smallmat_mul(F, S), geom)


def _scalar(x: torch.Tensor) -> torch.Tensor:
    """A per-element scalar (...) broadcast against (..., m, n) tensors."""
    return x[..., None, None]


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


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


class IsotropicIncompressibleElasticSwellingForm(BaseForm):
    """Incompressible swelling elasticity (nu = 0.5, a volumetric penalty
    ``k_swelling`` about the swollen volume ``v_swelling``)."""

    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "prop/emod": dg0_scalar(1.0),
        "prop/v_swelling": dg0_scalar(1.0),
        "prop/k_swelling": dg0_scalar(1.0),
    }

    def cell_kernel(self, geom, local):
        eps = strain_inf(grad_field(local["state/u1"], geom.grads))
        nu = 0.5
        lame_mu = local["prop/emod"] / 2 / (1 + nu)
        v, k = local["prop/v_swelling"], local["prop/k_swelling"]
        tr = eps[..., 0, 0] + eps[..., 1, 1] + eps[..., 2, 2]
        sigma = (2 * _scalar(lame_mu) * eps
                 + _scalar(k * (tr - (v - 1.0))) * _eye3(eps))
        return _stress_residual(sigma, geom)


def _swelling_pk2(grad_u, v, scale, emod, nu):
    """PK2 stress ``scale * v^(1/3) * sigma(E_v)`` of the swelling laws,
    with E_v the Green-Lagrange strain relative to the swollen state."""
    E = strain_green_lagrange(grad_u)
    w = v ** (-2 / 3)
    E_v = _scalar(w) * E + _scalar(0.5 * (w - 1.0)) * _eye3(E)
    return _scalar(scale * v ** (1 / 3)) * stress_isotropic(E_v, emod, nu)


class IsotropicElasticSwellingForm(BaseForm):
    """Gou2016 swelling hyperelasticity.  As the JAX package does (and not
    femvf, which hard-codes nu = 0.45 in the stress law), the stress reads
    the declared ``prop/nu``."""

    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "prop/emod": dg0_scalar(1.0),
        "prop/nu": const_scalar(0.45),
        "prop/v_swelling": dg0_scalar(1.0),
        "prop/m_swelling": dg0_scalar(0.0),
    }

    def cell_kernel(self, geom, local):
        grad_u = grad_field(local["state/u1"], geom.grads)
        v, m = local["prop/v_swelling"], local["prop/m_swelling"]
        mhat = m * (v - 1.0) + 1.0
        S = _swelling_pk2(grad_u, v, mhat, local["prop/emod"], local["prop/nu"])
        return _pk2_residual(S, def_grad(grad_u), geom)


class IsotropicElasticSwellingPowerLawForm(BaseForm):
    """Power-law swelling hyperelasticity (stiffness ``v^m``); the stress
    reads the declared ``prop/nu``, as in the JAX package."""

    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "state/v1": cg1_vector(),
        "prop/emod": dg0_scalar(1.0),
        "prop/nu": const_scalar(0.45),
        "prop/v_swelling": dg0_scalar(1.0),
        "prop/m_swelling": dg0_scalar(0.0),
    }

    def cell_kernel(self, geom, local):
        grad_u = grad_field(local["state/u1"], geom.grads)
        v, m = local["prop/v_swelling"], local["prop/m_swelling"]
        S = _swelling_pk2(grad_u, v, v**m, local["prop/emod"], local["prop/nu"])
        return _pk2_residual(S, def_grad(grad_u), geom)


class RayleighDampingForm(BaseForm):
    """Rayleigh damping: ``rayleigh_k`` times the elastic stress of the
    strain rate plus ``rayleigh_m`` times the mass term of the velocity."""

    COEFFICIENT_SPEC = {
        "state/v1": cg1_vector(),
        "prop/rho": dg0_scalar(1.0),
        "prop/emod": dg0_scalar(1.0),
        "prop/nu": const_scalar(0.45),
        "prop/rayleigh_m": const_scalar(1.0),
        "prop/rayleigh_k": const_scalar(1.0),
    }

    def cell_kernel(self, geom, local):
        v_e = local["state/v1"]
        rate = strain_inf(grad_field(v_e, geom.grads))
        sigma = _scalar(local["prop/rayleigh_k"]) * stress_isotropic(
            rate, local["prop/emod"], local["prop/nu"]
        )
        f = _scalar(local["prop/rayleigh_m"] * local["prop/rho"]) * interp(
            v_e, geom.bary
        )
        return _stress_residual(sigma, geom) + _force_residual(f, geom)


class KelvinVoigtForm(BaseForm):
    """Kelvin-Voigt viscosity."""

    COEFFICIENT_SPEC = {
        "state/v1": cg1_vector(),
        "prop/eta": dg0_scalar(1.0),
    }

    def cell_kernel(self, geom, local):
        rate = strain_inf(grad_field(local["state/v1"], geom.grads))
        return _stress_residual(local["prop/eta"][..., None, None] * rate, geom)


class APForceForm(BaseForm):
    """Anterior-posterior force approximating 3D effects; the form's own
    value is ``-(stiffness + viscous)``.  The viscous term's second
    difference is formed from ``u_ant``/``u_pos`` and the velocity, as the
    JAX package writes it (``vf_fem_tpu/fem/forms.py:455``)."""

    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "state/v1": cg1_vector(),
        "prop/eta": dg0_scalar(1.0),
        "prop/emod": dg0_scalar(1.0),
        "prop/nu": const_scalar(0.45),
        "prop/u_ant": dg0_scalar(0.0),
        "prop/u_pos": dg0_scalar(0.0),
        "prop/length": dg0_scalar(1.0),
        "prop/muscle_stress": dg0_scalar(0.0),
    }

    def cell_kernel(self, geom, local):
        u_q = interp(local["state/u1"], geom.bary)
        v_q = interp(local["state/v1"], geom.bary)
        lame_mu = local["prop/emod"] / 2 / (1 + local["prop/nu"])
        u_ant = _scalar(local["prop/u_ant"])
        u_pos = _scalar(local["prop/u_pos"])
        length2 = _scalar(local["prop/length"] ** 2)
        d2u = (u_ant - 2 * u_q + u_pos) / length2
        d2v = (u_ant - 2 * v_q + u_pos) / length2
        f_el = _scalar(lame_mu + local["prop/muscle_stress"]) * d2u
        f_vis = 0.5 * _scalar(local["prop/eta"]) * d2v
        return -_force_residual(f_el + f_vis, geom)


class ShapeForm(BaseForm):
    """Registers the mesh-shape parameter ``prop/umesh`` (the JAX package's
    ``ShapeForm``).  The shape enters every other kernel through the
    vertex coordinates (reference plus ``umesh``), so the kernel itself is
    zero."""

    COEFFICIENT_SPEC = {"prop/umesh": cg1_vector()}

    def cell_kernel(self, geom, local):
        return torch.zeros_like(geom.X)


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


class IsotropicIncompressibleMembraneForm(BaseForm):
    """Incompressible membrane (nu = 0.5) on the traction facets."""

    domain = "facet"
    COEFFICIENT_SPEC = {
        "state/u1": cg1_vector(),
        "prop/emod_membrane": dg0_scalar(0.0),
        "prop/th_membrane": dg0_scalar(0.0),
    }

    def facet_kernel(self, geom: FacetGeom, local):
        dim = geom.X.shape[-1]
        eps = strain_inf(grad_field(local["state/u1"], geom.grads))
        n3 = nnf.pad(geom.normal, (0, 3 - dim))
        P = _eye3(eps) - n3[..., :, None] * n3[..., None, :]
        eps_pp = smallmat_mul(smallmat_mul(P, eps), P)
        nu = 0.5
        lame_mu = local["prop/emod_membrane"] / 2 / (1 + nu)
        tr_pp = eps_pp[..., 0, 0] + eps_pp[..., 1, 1] + eps_pp[..., 2, 2]
        stress_pp = (2 * _scalar(lame_mu) * eps_pp
                     + _scalar(2 * lame_mu * tr_pp) * P)
        th = local["prop/th_membrane"]
        return (geom.meas * th)[..., None, None] * _membrane_rows(
            stress_pp, geom
        )
