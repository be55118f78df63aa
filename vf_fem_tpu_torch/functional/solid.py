"""
Solid-state trajectory functionals (counterpart of
``vf_fem_tpu.functional.solid``).

Volume and surface integrals use the residual's element quadrature on the
reference mesh, batched over cells (and over any leading axes of the
fields, such as time); derivatives come from autograd.
"""

from __future__ import annotations

import torch

from ..fem import assembly, elements
from ..fem.continuum import strain_inf, stress_isotropic
from ..fem.forms import facet_restrict, grad_field
from .base import AbstractFunctional


def _cells(model):
    """(topology, reference vertex coordinates of each cell (nc, nv, dim),
    shape gradients (nc, nv, dim), volumes (nc,)) of the solid."""
    res = model.solid.residual
    topo = res.topology
    Xe = res.X_ref[topo.cells]
    grads, vol = elements.cell_shape_gradients(Xe)
    return topo, Xe, grads, vol


def _nodal(model, w_flat):
    """A CG1 vector field (..., ndof) as cell-local nodal values
    (..., nc, nv, dim)."""
    solid = model.solid
    w = w_flat.reshape(*w_flat.shape[:-1], solid.nvert, solid.dim)
    return w[..., solid.residual.topology.cells, :]


def _quad_sq(topo, vol, w_e):
    """sum over cells of vol * sum_q w_q |w(x_q)|^2 for nodal values
    (..., nc, nv, dim)."""
    w_q = torch.einsum("qv,...cvd->...cqd", topo.cell_bary, w_e)
    return torch.sum(vol * torch.einsum("q,...cq->...c", topo.cell_qw,
                                        torch.sum(w_q ** 2, dim=-1)), dim=-1)


def _l2_volume_sq(model, w_flat):
    """The integral over the domain of ||w||^2 for a CG1 vector field."""
    topo, _, _, vol = _cells(model)
    return _quad_sq(topo, vol, _nodal(model, w_flat))


def _l2_surface_sq(model, w_flat):
    """The integral over the 'pressure' surface of ||w||^2."""
    solid = model.solid
    topo = solid.residual.topology
    cv = topo.cells[topo.facet_cells]
    w = w_flat.reshape(*w_flat.shape[:-1], solid.nvert, solid.dim)[..., cv, :]
    geom = assembly.make_facet_geom(solid.residual.X_ref[cv], topo.facet_sel,
                                    topo.facet_opp_sel, topo)
    w_q = torch.einsum("qd,...fdc->...fqc", geom.fbary, facet_restrict(w, geom.sel))
    return torch.sum(geom.meas * torch.einsum("q,...fq->...f", geom.fqw,
                                              torch.sum(w_q ** 2, dim=-1)), dim=-1)


def _strain(model, w_flat, grads):
    """The infinitesimal strain (3x3) of a CG1 field in each cell."""
    return strain_inf(grad_field(_nodal(model, w_flat), grads))


def _elastic_energy(model, u_flat, props):
    """The integral of sigma(u) : eps(u)."""
    _, _, grads, vol = _cells(model)
    eps = _strain(model, u_flat, grads)
    sig = stress_isotropic(eps, props["emod"], props["nu"][0])
    return torch.sum(vol * torch.sum(sig * eps, dim=(-2, -1)), dim=-1)


def _kv_dissipation_rate(model, v_flat, props):
    """The integral of eta * strain_rate : strain_rate."""
    _, _, grads, vol = _cells(model)
    rate = _strain(model, v_flat, grads)
    return torch.sum(vol * props["eta"] * torch.sum(rate * rate, dim=(-2, -1)),
                     dim=-1)


def _trapz(y, t):
    dt = torch.diff(t)
    return torch.sum(0.5 * dt * (y[1:] + y[:-1]))


class SolidFunctional(AbstractFunctional):
    pass


class PeriodicError(SolidFunctional):
    """alpha^2 ||u(T)-u(0)||^2 + ||v(T)-v(0)||^2 + ||a(T)-a(0)||^2 (L2)."""

    default_constants = {"alpha": 1e3}

    def eval_traj(self, traj, times, controls, props):
        alpha = self.constants["alpha"]
        erru = _l2_volume_sq(self.model, traj["u"][-1] - traj["u"][0])
        errv = _l2_volume_sq(self.model, traj["v"][-1] - traj["v"][0])
        erra = _l2_volume_sq(self.model, traj["a"][-1] - traj["a"][0])
        return alpha**2 * erru + errv + erra


class ComponentPeriodicError(SolidFunctional):
    """The periodic error of one state component."""

    component = "u"

    def eval_traj(self, traj, times, controls, props):
        c = self.component
        return _l2_volume_sq(self.model, traj[c][-1] - traj[c][0])


class UPeriodicError(ComponentPeriodicError):
    component = "u"


class VPeriodicError(ComponentPeriodicError):
    component = "v"


class APeriodicError(ComponentPeriodicError):
    component = "a"


class PeriodicEnergyError(SolidFunctional):
    """The squared change of (kinetic + elastic) energy over the run."""

    default_constants = {"alpha": 1.0}

    def _energy(self, u, v, props):
        topo, _, _, vol = _cells(self.model)
        v_q = torch.einsum("qv,...cvd->...cqd", topo.cell_bary, _nodal(self.model, v))
        kinetic = torch.sum(0.5 * props["rho"] * vol * torch.einsum(
            "q,...cq->...c", topo.cell_qw, torch.sum(v_q ** 2, dim=-1)), dim=-1)
        return kinetic + 0.5 * _elastic_energy(self.model, u, props)

    def eval_traj(self, traj, times, controls, props):
        e0 = self._energy(traj["u"][0], traj["v"][0], props)
        eN = self._energy(traj["u"][-1], traj["v"][-1], props)
        return (eN - e0) ** 2


class FinalDisplacementNorm(SolidFunctional):
    """||u(T)||_L2."""

    def eval_traj(self, traj, times, controls, props):
        return torch.sqrt(_l2_volume_sq(self.model, traj["u"][-1]))


class FinalVelocityNorm(SolidFunctional):
    """||v(T)||_L2."""

    def eval_traj(self, traj, times, controls, props):
        return torch.sqrt(_l2_volume_sq(self.model, traj["v"][-1]))


class FinalSurfaceDisplacementNorm(SolidFunctional):
    """||u(T)||_L2 over the pressure surface."""

    def eval_traj(self, traj, times, controls, props):
        return torch.sqrt(_l2_surface_sq(self.model, traj["u"][-1]))


class ElasticEnergyDifference(SolidFunctional):
    """(E_elastic(T) - E_elastic(0))^2."""

    def eval_traj(self, traj, times, controls, props):
        e0 = _elastic_energy(self.model, traj["u"][0], props)
        eN = _elastic_energy(self.model, traj["u"][-1], props)
        return (eN - e0) ** 2


class KVDampingWork(SolidFunctional):
    """Viscous dissipation integrated over time (trapezoid rule)."""

    default_constants = {"n_start": 0}

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        rates = _kv_dissipation_rate(self.model, traj["v"][n0:], props)
        return _trapz(rates, times[n0:])


class KV3DDampingWork(SolidFunctional):
    """Approximate-3D viscous dissipation: the planar Kelvin-Voigt rate plus
    the anterior-posterior term ``eta |v|^2 / length^2`` (clamped
    anterior/posterior planes).  ``length`` is a property (the AP fold
    length), 1 where the residual has none."""

    default_constants = {"n_start": 0}

    def _rate(self, v_flat, props):
        topo, _, grads, vol = _cells(self.model)
        eta = props["eta"]
        length = props.get("length", torch.ones((), dtype=eta.dtype, device=eta.device))
        length = torch.broadcast_to(length, eta.shape)
        rate = _strain(self.model, v_flat, grads)
        planar = vol * eta * torch.sum(rate * rate, dim=(-2, -1))
        v_q = torch.einsum("qv,...cvd->...cqd", topo.cell_bary, _nodal(self.model, v_flat))
        ap = vol * eta / length**2 * torch.einsum(
            "q,...cq->...c", topo.cell_qw, torch.sum(v_q ** 2, dim=-1))
        return torch.sum(planar + ap, dim=-1)

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        return _trapz(self._rate(traj["v"][n0:], props), times[n0:])


class RayleighDampingWork(SolidFunctional):
    """Rayleigh-damping dissipation integrated over time."""

    default_constants = {"n_start": 0}

    def _rate(self, v_flat, props):
        topo, _, grads, vol = _cells(self.model)
        rate = _strain(self.model, v_flat, grads)
        sig = props["rayleigh_k"][0] * stress_isotropic(rate, props["emod"],
                                                        props["nu"][0])
        visc_stress = vol * torch.sum(sig * rate, dim=(-2, -1))
        v_q = torch.einsum("qv,...cvd->...cqd", topo.cell_bary, _nodal(self.model, v_flat))
        visc_mass = props["rayleigh_m"][0] * props["rho"] * vol * torch.einsum(
            "q,...cq->...c", topo.cell_qw, torch.sum(v_q ** 2, dim=-1))
        return torch.sum(visc_stress + visc_mass, dim=-1)

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        return _trapz(self._rate(traj["v"][n0:], props), times[n0:])


class GlottalWidthErrorNorm(SolidFunctional):
    """The sum of squared errors between the model's glottal width signal
    (a smooth minimum, by log-sum-exp, of the width along the surface) and
    a measured one.  Constants: ``gw_meas`` (the measured signal at each
    stored state) and ``smooth_min_alpha``."""

    default_constants = {"gw_meas": None, "smooth_min_alpha": -2000.0}

    def eval_traj(self, traj, times, controls, props):
        model = self.model
        solid = model.solid
        u = traj["u"].reshape(*traj["u"].shape[:-1], solid.nvert, solid.dim)
        y_srf = (solid.residual.X_ref + u)[..., model._solid_dofs, 1]
        area = 2.0 * (props["ymid"][0] - y_srf)
        alpha = self.constants["smooth_min_alpha"]
        gw = torch.logsumexp(alpha * area, dim=-1) / alpha
        gw_meas = torch.as_tensor(self.constants["gw_meas"], dtype=gw.dtype,
                                  device=gw.device)
        return torch.sum((gw - gw_meas) ** 2)
