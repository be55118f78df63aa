"""
Model factory: build solid, fluid, coupled FSI and FSAI models from
meshes (counterpart of ``vf_fem_tpu.load``).  ``device`` and ``dtype`` are
fixed here: every static array of the model is built on that device once.
"""

from __future__ import annotations

from os import path
from typing import Optional, Sequence, Union

import numpy as np

from . import config
from .mesh import Mesh, derive_1d_interface, load_gmsh
from .mesh.reorder import rcm_mesh
from .models import transient
from .residuals import fluid as flr
from .residuals import solid as slr


def load_solid_model(
    mesh: Union[str, Mesh],
    Residual: type,
    device=config.DEFAULT_DEVICE,
    dtype=config.DEFAULT_DTYPE,
    reorder: Optional[str] = None,
    **kwargs,
) -> transient.SolidModel:
    """Load a transient solid model from a ``.msh`` path or a :class:`Mesh`.

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
    residual = Residual(mesh, device=device, dtype=dtype, **kwargs)
    return transient.SolidModel(residual)


def load_fluid_model(
    mesh: np.ndarray,
    Residual: type,
    device=config.DEFAULT_DEVICE,
    dtype=config.DEFAULT_DTYPE,
    **kwargs,
) -> transient.FluidModel:
    """Load a quasi-steady 1D fluid model on arc-length coordinates."""
    return transient.FluidModel(
        Residual(mesh, device=device, dtype=dtype, **kwargs)
    )


def load_fsi_model(
    solid_mesh: Union[str, Mesh],
    SolidResidual: type = slr.KelvinVoigt,
    FluidResidual: type = flr.BernoulliSmoothMinSep,
    solid_kwargs: dict = None,
    fluid_kwargs: dict = None,
    coupling: str = "explicit",
    fluid_interface_subdomains: Sequence[str] = ("pressure",),
    device=config.DEFAULT_DEVICE,
    dtype=config.DEFAULT_DTYPE,
    reorder: Optional[str] = None,
):
    """Build the solid, derive the 1D fluid interface from the 'pressure'
    facet subdomain, build the fluid and couple the two: staggered
    (``coupling='explicit'``, :class:`~.models.transient.ExplicitFSIModel`)
    or by Picard iteration (``'implicit'``,
    :class:`~.models.transient.ImplicitFSIModel`)."""
    models = {"explicit": transient.ExplicitFSIModel,
              "implicit": transient.ImplicitFSIModel}
    if coupling not in models:
        raise ValueError(f"Invalid `coupling` {coupling!r} (use 'explicit' or 'implicit')")
    device = config.model_device(device)
    solid = load_solid_model(
        solid_mesh, SolidResidual, device=device, dtype=dtype,
        reorder=reorder, **(solid_kwargs or {}),
    )
    mesh = solid.residual.mesh()
    s, dofs_fsi_solid, dofs_fsi_fluid = derive_1d_interface(
        mesh, fluid_interface_subdomains
    )
    fluid = load_fluid_model(
        s, FluidResidual, device=device, dtype=dtype, **(fluid_kwargs or {})
    )
    return models[coupling](solid, fluid, dofs_fsi_solid, dofs_fsi_fluid)


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
