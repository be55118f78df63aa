"""
Solid field measures (counterpart of ``vf_fem_tpu.postprocess.solid``).

All stress and strain fields are DG0 (per cell), evaluated directly from
the constant P1 element gradients.  Each ``assem_pure`` is batched tensor
arithmetic over the cells on the model's device, and runs unchanged under
``TimeSeries``' ``vmap`` over states (no branch reads a tensor's value).
``prop`` is host numpy: per-cell properties move to the device, scalar
ones are read as Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.continuum import pressure_contact_cubic_penalty, strain_inf, stress_isotropic
from ..fem.elements import cell_shape_gradients
from ..fem.forms import grad_field
from ..functional.fsi import _fluid_work_rate
from ..models.transient import pressure_to_solid
from .base import BaseStateMeasure


def _solid(model):
    return getattr(model, "solid", model)


def _prop_tensor(model, prop, key):
    """A per-cell property on the model's device."""
    return torch.as_tensor(np.asarray(prop[key]), dtype=model.dtype, device=model.device)


def _cell_grads_of(model, w_flat):
    """(n_cells, dim, dim) constant gradients of a CG1 vector field, and
    the cell areas."""
    solid = _solid(model)
    cells = solid.residual.topology.cells
    X = solid.residual.X_ref
    grads, vol = cell_shape_gradients(X[cells])
    return grad_field(w_flat.reshape(-1, solid.dim)[cells], grads), vol


def _stress_field(model, state, prop):
    """(n_cells, 3, 3) Cauchy stress (small strain), strain and areas."""
    grads_u, vol = _cell_grads_of(model, state["u"])
    eps = strain_inf(grads_u)
    nu = float(np.asarray(prop["nu"])[0])
    return stress_isotropic(eps, _prop_tensor(model, prop, "emod"), nu), eps, vol


def _trace(a):
    return a.diagonal(dim1=-2, dim2=-1).sum(-1)


def _det3(a):
    """Determinants of (..., 3, 3) tensors by cofactors."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


class BaseSolidMeasure(BaseStateMeasure):
    pass


class StressI1Field(BaseSolidMeasure):
    """First stress invariant tr(sigma)."""

    def assem_pure(self, state, control, prop):
        sig, _, _ = _stress_field(self.model, state, prop)
        return _trace(sig)


class StressI2Field(BaseSolidMeasure):
    """Second stress invariant."""

    def assem_pure(self, state, control, prop):
        sig, _, _ = _stress_field(self.model, state, prop)
        return 0.5 * (_trace(sig) ** 2 - _trace(sig @ sig))


class StressI3Field(BaseSolidMeasure):
    """Third stress invariant det(sigma)."""

    def assem_pure(self, state, control, prop):
        sig, _, _ = _stress_field(self.model, state, prop)
        return _det3(sig)


class StressHydrostaticField(BaseSolidMeasure):
    """-tr(sigma)/3."""

    def assem_pure(self, state, control, prop):
        sig, _, _ = _stress_field(self.model, state, prop)
        return -_trace(sig) / 3


class StressVonMisesField(BaseSolidMeasure):
    """Von Mises stress."""

    def assem_pure(self, state, control, prop):
        sig, _, _ = _stress_field(self.model, state, prop)
        eye = torch.eye(3, dtype=sig.dtype, device=sig.device)
        dev = sig - _trace(sig)[:, None, None] / 3 * eye
        return torch.sqrt(3 * (0.5 * torch.sum(dev * dev, dim=(1, 2))))


class ElasticStressField(BaseSolidMeasure):
    """The elastic stress tensor field."""

    def assem_pure(self, state, control, prop):
        sig, _, _ = _stress_field(self.model, state, prop)
        return sig


class StrainEnergy(BaseSolidMeasure):
    """Total strain energy, the integral of sigma:eps."""

    def assem_pure(self, state, control, prop):
        sig, eps, vol = _stress_field(self.model, state, prop)
        return torch.sum(vol * torch.sum(sig * eps, dim=(1, 2)))


class StrainEnergyRate(BaseSolidMeasure):
    """The strain energy's rate, the integral of 2 sigma(u):eps(v)."""

    def assem_pure(self, state, control, prop):
        sig, _, vol = _stress_field(self.model, state, prop)
        grads_v, _ = _cell_grads_of(self.model, state["v"])
        return 2 * torch.sum(vol * torch.sum(sig * strain_inf(grads_v), dim=(1, 2)))


class PositiveStrainEnergyRate(BaseSolidMeasure):
    """max(0, strain energy rate)."""

    def assem_pure(self, state, control, prop):
        rate = StrainEnergyRate(self.model).assem_pure(state, control, prop)
        return torch.clamp(rate, min=0.0)


def _contact_gap(model, state, prop):
    """The nodal gap to the contact plane."""
    solid = _solid(model)
    u = state["u"].reshape(-1, solid.dim)
    n = torch.as_tensor(np.asarray(prop["ncontact"]), dtype=u.dtype, device=u.device)
    y = float(np.asarray(prop["ycontact"])[0])
    return (solid.residual.X_ref + u) @ n - y


class ContactPressureField(BaseSolidMeasure):
    """Nodal penalty contact pressure."""

    def assem_pure(self, state, control, prop):
        k = float(np.asarray(prop["kcontact"])[0])
        return pressure_contact_cubic_penalty(_contact_gap(self.model, state, prop), k)


class ViscousDissipationField(BaseSolidMeasure):
    """Per-cell Kelvin–Voigt dissipation density eta eps_rate:eps_rate."""

    def assem_pure(self, state, control, prop):
        grads_v, _ = _cell_grads_of(self.model, state["v"])
        rate = strain_inf(grads_v)
        return _prop_tensor(self.model, prop, "eta") * torch.sum(rate * rate, dim=(1, 2))


class ViscousDissipationRate(BaseSolidMeasure):
    """Total Kelvin–Voigt dissipation rate."""

    def assem_pure(self, state, control, prop):
        grads_v, vol = _cell_grads_of(self.model, state["v"])
        rate = strain_inf(grads_v)
        eta = _prop_tensor(self.model, prop, "eta")
        return torch.sum(vol * eta * torch.sum(rate * rate, dim=(1, 2)))


class ContactAreaDensity(BaseSolidMeasure):
    """Indicator of nodal contact (gap > 0)."""

    def assem_pure(self, state, control, prop):
        gap = _contact_gap(self.model, state, prop)
        return (gap > 0).to(gap.dtype)


class XMomentum(BaseSolidMeasure):
    """Total x-momentum, the integral of rho v_x."""

    component = 0

    def assem_pure(self, state, control, prop):
        solid = _solid(self.model)
        topo = solid.residual.topology
        v = state["v"].reshape(-1, solid.dim)
        _, vol = cell_shape_gradients(solid.residual.X_ref[topo.cells])
        v_q = torch.einsum("qv,cv->cq", topo.cell_bary, v[topo.cells][..., self.component])
        rho = _prop_tensor(self.model, prop, "rho")
        return torch.sum(rho * vol * torch.sum(topo.cell_qw * v_q, dim=-1))


class YMomentum(XMomentum):
    """Total y-momentum."""

    component = 1


class FieldStats(BaseSolidMeasure):
    """(max, min, avg, total) of another field measure."""

    def __init__(self, model, field_measure: BaseStateMeasure, **kwargs):
        super().__init__(model, **kwargs)
        self.field = field_measure

    def assem_pure(self, state, control, prop):
        vals = self.field.assem_pure(state, control, prop)
        return {"max": vals.max(), "min": vals.min(), "avg": vals.mean(),
                "total": vals.sum()}


def _surface_areas(model, state, prop):
    """The channel areas 2 (ymid - y) at the interface's solid vertices."""
    solid = _solid(model)
    u = state["u"].reshape(-1, solid.dim)
    ymid = float(np.asarray(prop["ymid"])[0])
    y_srf = (solid.residual.X_ref + u)[model._solid_dofs, 1]
    return 2.0 * (ymid - y_srf)


class MeanGlottalWidth(BaseSolidMeasure):
    """Mean channel area over the interface."""

    def assem_pure(self, state, control, prop):
        return torch.mean(_surface_areas(self.model, state, prop))


class MidpointGlottalWidth(BaseSolidMeasure):
    """Channel area at the interface's midpoint."""

    def assem_pure(self, state, control, prop):
        areas = _surface_areas(self.model, state, prop)
        return areas[areas.shape[0] // 2]


class MinGlottalWidthFromSolid(BaseSolidMeasure):
    """Minimum glottal width from the solid surface."""

    def assem_pure(self, state, control, prop):
        return torch.min(_surface_areas(self.model, state, prop))


class VertexGlottalWidth(BaseSolidMeasure):
    """Glottal width at a named vertex."""

    def __init__(self, model, vertex_name: str = "separation", **kwargs):
        super().__init__(model, **kwargs)
        from ..mesh.interface import locate_separation_vertex

        self.vertex = locate_separation_vertex(_solid(model).residual.mesh(), vertex_name)

    def assem_pure(self, state, control, prop):
        solid = _solid(self.model)
        u = state["u"].reshape(-1, solid.dim)
        ymid = float(np.asarray(prop["ymid"])[0])
        return 2.0 * (ymid - (solid.residual.X_ref[self.vertex, 1] + u[self.vertex, 1]))


class FSIPressure(BaseSolidMeasure):
    """The fluid pressure on the solid's vertices (zero off the
    interface)."""

    def assem_pure(self, state, control, prop):
        model = self.model
        return pressure_to_solid(state["p"], model.solid.nvert, model._solid_dofs,
                                 model._fluid_dofs)


class FluidTractionPowerDensity(BaseSolidMeasure):
    """Interface power p (cof(F) n) . v, integrated over the interface."""

    def assem_pure(self, state, control, prop):
        return _fluid_work_rate(self.model, state["u"], state["v"], state["p"])
