"""
FSI energy-transfer functionals (counterpart of
``vf_fem_tpu.functional.fsi``).
"""

from __future__ import annotations

import torch

from ..fem import assembly
from ..fem.continuum import pullback_area_normal
from ..fem.forms import facet_restrict, grad_field
from .base import AbstractFunctional


def _fluid_work_rate(model, u_flat, v_flat, p_fluid):
    """The fluid-to-solid power, the integral over the interface of
    p (cof(F) n) . v ds, batched over leading axes."""
    solid = model.solid
    topo = solid.residual.topology
    lead = u_flat.shape[:-1]
    u = u_flat.reshape(*lead, solid.nvert, solid.dim)
    v = v_flat.reshape(*lead, solid.nvert, solid.dim)
    # the fluid pressure on the solid's vertices
    p_solid = p_fluid.new_zeros((*lead, solid.nvert))
    p_solid[..., model._solid_dofs] = p_fluid[..., model._fluid_dofs]
    cv = topo.cells[topo.facet_cells]
    geom = assembly.make_facet_geom(solid.residual.X_ref[cv], topo.facet_sel,
                                    topo.facet_opp_sel, topo)
    pn = pullback_area_normal(grad_field(u[..., cv, :], geom.grads), geom.normal)
    p_q = torch.einsum("qd,...fd->...fq", geom.fbary,
                       torch.einsum("...fvd,...fv->...fd", geom.sel, p_solid[..., cv]))
    v_q = torch.einsum("qd,...fdc->...fqc", geom.fbary,
                       facet_restrict(v[..., cv, :], geom.sel))
    power_q = p_q * torch.einsum("...fqc,...fc->...fq", v_q, pn)
    return torch.sum(geom.meas * torch.einsum("q,...fq->...f", geom.fqw, power_q),
                     dim=-1)


class TransferWorkbyVelocity(AbstractFunctional):
    """The work transferred to the solid: p cof(F) n . v over the interface,
    integrated over time (trapezoid rule)."""

    default_constants = {"n_start": 0}

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        rates = _fluid_work_rate(self.model, traj["u"][n0:], traj["v"][n0:],
                                 traj["p"][n0:])
        t = times[n0:]
        return torch.sum(0.5 * torch.diff(t) * (rates[1:] + rates[:-1]))


class TransferWorkbyDisplacementIncrement(AbstractFunctional):
    """The work by displacement increments: sum_n of the integral of
    p_n cof(F_n) n . (u_{n+1} - u_n) ds."""

    default_constants = {"n_start": 0}

    def eval_traj(self, traj, times, controls, props):
        n0 = self.constants["n_start"]
        u = traj["u"][n0:]
        p = traj["p"][n0:]
        return torch.sum(_fluid_work_rate(self.model, u[:-1], u[1:] - u[:-1], p[:-1]))
