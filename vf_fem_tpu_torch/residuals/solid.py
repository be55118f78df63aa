"""
Predefined solid residuals, all ten of ``vf_fem_tpu.residuals.solid``, with
the same signed form composition.  Surface pressure and contact traction
act on the 'pressure' facet subdomain.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .. import config
from ..fem import forms as F
from ..mesh.core import Mesh
from .base import FemResidual


class PredefinedSolidResidual(FemResidual):
    """Composes the signed form list returned by ``init_form``."""

    def __init__(
        self,
        mesh: Mesh,
        dirichlet_bcs: Optional[dict] = None,
        traction_subdomains: Sequence[str] = ("pressure",),
        device=config.DEFAULT_DEVICE,
        dtype=config.DEFAULT_DTYPE,
    ):
        super().__init__(
            self.init_form(),
            mesh,
            traction_subdomains=traction_subdomains,
            dirichlet_bc_specs=dirichlet_bcs,
            device=device,
            dtype=dtype,
        )

    def init_form(self):
        raise NotImplementedError()


class Rayleigh(PredefinedSolidResidual):
    """Linear elasticity with Rayleigh (mass and stiffness) damping."""

    def init_form(self):
        return [
            (1.0, F.InertialForm()),
            (1.0, F.IsotropicElasticForm()),
            (1.0, F.RayleighDampingForm()),
            (-1.0, F.SurfacePressureForm()),
            (-1.0, F.ManualSurfaceContactTractionForm()),
        ]


class KelvinVoigt(PredefinedSolidResidual):
    def init_form(self):
        return [
            (1.0, F.InertialForm()),
            (1.0, F.KelvinVoigtForm()),
            (1.0, F.IsotropicElasticForm()),
            (-1.0, F.SurfacePressureForm()),
            (-1.0, F.ManualSurfaceContactTractionForm()),
        ]


class KelvinVoigtWShape(PredefinedSolidResidual):
    """KelvinVoigt with the mesh shape ``prop/umesh`` as a property (the
    shape-optimization residual, ``parameters.transform.TractionShape``)."""

    def init_form(self):
        return [
            (1.0, F.InertialForm()),
            (1.0, F.IsotropicElasticForm()),
            (1.0, F.KelvinVoigtForm()),
            (-1.0, F.SurfacePressureForm()),
            (-1.0, F.ManualSurfaceContactTractionForm()),
            (-1.0, F.ShapeForm()),
        ]


class KelvinVoigtWEpithelium(PredefinedSolidResidual):
    def init_form(self):
        return [
            (1.0, F.InertialForm()),
            (1.0, F.IsotropicMembraneForm()),
            (1.0, F.IsotropicElasticForm()),
            (1.0, F.KelvinVoigtForm()),
            (-1.0, F.SurfacePressureForm()),
            (-1.0, F.ManualSurfaceContactTractionForm()),
        ]


class IncompSwellingKelvinVoigt(PredefinedSolidResidual):
    def init_form(self):
        return [
            (1.0, F.InertialForm()),
            (1.0, F.IsotropicIncompressibleElasticSwellingForm()),
            (1.0, F.KelvinVoigtForm()),
            (-1.0, F.SurfacePressureForm()),
            (-1.0, F.ManualSurfaceContactTractionForm()),
        ]


class SwellingKelvinVoigt(PredefinedSolidResidual):
    def init_form(self):
        return [
            (1.0, F.InertialForm()),
            (1.0, F.IsotropicElasticSwellingForm()),
            (1.0, F.KelvinVoigtForm()),
            (-1.0, F.SurfacePressureForm()),
            (-1.0, F.ManualSurfaceContactTractionForm()),
        ]


def _swelling_w_epithelium(swelling_form):
    return [
        (1.0, F.InertialForm()),
        (1.0, F.IsotropicMembraneForm()),
        (1.0, swelling_form),
        (1.0, F.KelvinVoigtForm()),
        (-1.0, F.SurfacePressureForm()),
        (-1.0, F.ManualSurfaceContactTractionForm()),
    ]


class SwellingKelvinVoigtWEpithelium(PredefinedSolidResidual):
    def init_form(self):
        return _swelling_w_epithelium(F.IsotropicElasticSwellingForm())


class SwellingKelvinVoigtWEpitheliumNoShape(PredefinedSolidResidual):
    """The same forms as :class:`SwellingKelvinVoigtWEpithelium` (neither
    package's variant carries a shape parameter)."""

    def init_form(self):
        return _swelling_w_epithelium(F.IsotropicElasticSwellingForm())


class SwellingPowerLawKelvinVoigtWEpitheliumNoShape(PredefinedSolidResidual):
    def init_form(self):
        return _swelling_w_epithelium(F.IsotropicElasticSwellingPowerLawForm())


class Approximate3DKelvinVoigt(PredefinedSolidResidual):
    """KelvinVoigt with an epithelium and the anterior-posterior force of
    the clamped planes beside the section."""

    def init_form(self):
        return [
            (1.0, F.InertialForm()),
            (1.0, F.IsotropicMembraneForm()),
            (1.0, F.IsotropicElasticForm()),
            (-1.0, F.APForceForm()),
            (1.0, F.KelvinVoigtForm()),
            (-1.0, F.SurfacePressureForm()),
            (-1.0, F.ManualSurfaceContactTractionForm()),
        ]
