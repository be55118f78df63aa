"""
Model factory: build solid, fluid, coupled FSI and FSAI models from
meshes (counterpart of ``vf_fem_tpu.load``).  ``device`` and ``dtype`` are
fixed here: every static array of the model is built on that device once.
``model_type`` is 'transient' (time stepping, ``models.transient``),
'dynamical' or 'linearized_dynamical' (first-order residuals and their
Jacobians for linear stability, ``models.dynamical``).
"""

from __future__ import annotations

from os import path
from typing import Optional, Sequence, Union

import numpy as np

from . import config
from .mesh import Mesh, derive_1d_interface, load_gmsh, locate_separation_vertex
from .mesh.reorder import rcm_mesh
from .models import dynamical, transient
from .residuals import fluid as flr
from .residuals import solid as slr


_SOLID_MODELS = {"transient": transient.SolidModel,
                 "dynamical": dynamical.SolidDynamicalModel,
                 "linearized_dynamical": dynamical.LinearizedSolidDynamicalModel}
_FLUID_MODELS = {"transient": transient.FluidModel,
                 "dynamical": dynamical.FluidDynamicalModel,
                 "linearized_dynamical": dynamical.LinearizedFluidDynamicalModel}
_FSI_DYNAMICAL_MODELS = {"dynamical": dynamical.FSIDynamicalModel,
                         "linearized_dynamical": dynamical.LinearizedFSIDynamicalModel}


def _model_class(models: dict, model_type: str):
    if model_type not in models:
        raise ValueError(f"Invalid model type {model_type}")
    return models[model_type]


def load_solid_model(
    mesh: Union[str, Mesh],
    Residual: type,
    model_type: str = "transient",
    device=config.DEFAULT_DEVICE,
    dtype=config.DEFAULT_DTYPE,
    reorder: Optional[str] = None,
    **kwargs,
):
    """Load a solid model of ``model_type`` from a ``.msh`` path or a
    :class:`Mesh`.

    ``reorder='rcm'`` renumbers the vertices by reverse Cuthill–McKee
    first, as the block-banded solver (``linear_solver='bsb'``) needs on a
    mesh that is not bandwidth-ordered."""
    if isinstance(mesh, str):
        ext = path.splitext(mesh)[1]
        if ext.lower() != ".msh":
            raise ValueError(f"Invalid mesh extension {ext}")
        mesh = load_gmsh(mesh)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"Invalid `mesh` type {type(mesh)}")
    if reorder == "rcm":
        mesh = rcm_mesh(mesh)
    elif reorder is not None:
        raise ValueError(f"Invalid reorder {reorder!r} (use 'rcm' or None)")
    Model = _model_class(_SOLID_MODELS, model_type)
    return Model(Residual(mesh, device=device, dtype=dtype, **kwargs))


def load_fluid_model(
    mesh: np.ndarray,
    Residual: type,
    model_type: str = "transient",
    device=config.DEFAULT_DEVICE,
    dtype=config.DEFAULT_DTYPE,
    **kwargs,
):
    """Load a quasi-steady 1D fluid model of ``model_type`` on arc-length
    coordinates."""
    Model = _model_class(_FLUID_MODELS, model_type)
    return Model(Residual(mesh, device=device, dtype=dtype, **kwargs))


def separation_index(mesh: Mesh, dofs_fsi_solid: np.ndarray,
                     label: str = "separation") -> Optional[int]:
    """The interface position of the mesh's ``label`` vertex, or None where
    the mesh has no such single vertex or it is not on the interface."""
    try:
        sep_vert = locate_separation_vertex(mesh, label)
    except ValueError:
        return None
    matches = np.nonzero(np.asarray(dofs_fsi_solid) == sep_vert)[0]
    return int(matches[0]) if len(matches) else None


def load_fsi_model(
    solid_mesh: Union[str, Mesh],
    SolidResidual: type = slr.KelvinVoigt,
    FluidResidual: type = flr.BernoulliSmoothMinSep,
    solid_kwargs: dict = None,
    fluid_kwargs: dict = None,
    model_type: str = "transient",
    coupling: str = "explicit",
    fluid_interface_subdomains: Sequence[str] = ("pressure",),
    zs: Optional[np.ndarray] = None,
    device=config.DEFAULT_DEVICE,
    dtype=config.DEFAULT_DTYPE,
    reorder: Optional[str] = None,
):
    """Build the solid, derive the 1D fluid interface from the 'pressure'
    facet subdomain (on a 3D mesh one channel on each z-plane of ``zs``),
    build the fluid and couple the two.  A transient
    model is coupled staggered (``coupling='explicit'``,
    :class:`~.models.transient.ExplicitFSIModel`) or by Picard iteration
    (``'implicit'``, :class:`~.models.transient.ImplicitFSIModel`); a
    'dynamical' or 'linearized_dynamical' one is
    :class:`~.models.dynamical.FSIDynamicalModel` or
    :class:`~.models.dynamical.LinearizedFSIDynamicalModel`, whatever
    ``coupling``.  A fixed-separation fluid without ``idx_sep`` in
    ``fluid_kwargs`` separates at the interface position of the mesh's
    'separation' vertex where it has one (else at the residual's default,
    0), as in the JAX package."""
    if model_type == "transient":
        models = {"explicit": transient.ExplicitFSIModel,
                  "implicit": transient.ImplicitFSIModel}
        if coupling not in models:
            raise ValueError(f"Invalid `coupling` {coupling!r} (use 'explicit' or 'implicit')")
        FSIModel = models[coupling]
    else:
        FSIModel = _model_class(_FSI_DYNAMICAL_MODELS, model_type)
    device = config.model_device(device)
    solid = load_solid_model(
        solid_mesh, SolidResidual, model_type=model_type, device=device,
        dtype=dtype, reorder=reorder, **(solid_kwargs or {}),
    )
    mesh = solid.residual.mesh()
    s, dofs_fsi_solid, dofs_fsi_fluid = derive_1d_interface(
        mesh, fluid_interface_subdomains, zs
    )
    fluid_kwargs = dict(fluid_kwargs or {})
    if (FluidResidual in (flr.BernoulliFixedSep, flr.BernoulliFlowFixedSep)
            and "idx_sep" not in fluid_kwargs):
        idx_sep = separation_index(mesh, dofs_fsi_solid)
        if idx_sep is not None:
            fluid_kwargs["idx_sep"] = idx_sep
    fluid = load_fluid_model(
        s, FluidResidual, model_type=model_type, device=device, dtype=dtype,
        **fluid_kwargs
    )
    return FSIModel(solid, fluid, dofs_fsi_solid, dofs_fsi_fluid)


def load_fsai_model(
    solid_mesh: Union[str, Mesh],
    SolidResidual: type = slr.KelvinVoigt,
    FluidResidual: type = flr.BernoulliSmoothMinSep,
    num_tube: int = 44,
    device=config.DEFAULT_DEVICE,
    dtype=config.DEFAULT_DTYPE,
    **fsi_kwargs,
):
    """Build a two-way coupled fluid-solid-acoustic model
    (:class:`~.models.fsai.ExplicitFSAIModel`): an explicitly coupled FSI
    model (:func:`load_fsi_model` with ``coupling='explicit'``; passing
    ``coupling`` raises, as in the JAX package) and a WRA vocal tract of
    ``num_tube`` tubes whose input pressure is the fluid's supraglottal
    pressure.  Drive it at the tract's geometry-locked time step,
    ``model.dt``."""
    from .models.acoustic import WRAnalog
    from .models.fsai import ExplicitFSAIModel

    device = config.model_device(device)
    fsi = load_fsi_model(
        solid_mesh, SolidResidual, FluidResidual, coupling="explicit",
        device=device, dtype=dtype, **fsi_kwargs,
    )
    return ExplicitFSAIModel(fsi, WRAnalog(num_tube, device=device, dtype=dtype))
