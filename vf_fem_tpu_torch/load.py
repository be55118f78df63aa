"""
Model factory: build solid, fluid and explicitly coupled FSI models from
meshes (counterpart of ``vf_fem_tpu.load``).  ``device`` and ``dtype`` are
fixed here: every static array of the model is built on that device once.
"""

from __future__ import annotations

from os import path
from typing import Sequence, Union

import numpy as np
import torch

from . import config
from .mesh import Mesh, derive_1d_interface, load_gmsh
from .models import transient
from .residuals import fluid as flr
from .residuals import solid as slr


def load_solid_model(
    mesh: Union[str, Mesh],
    Residual: type,
    device="cpu",
    dtype=config.DEFAULT_DTYPE,
    **kwargs,
) -> transient.SolidModel:
    """Load a transient solid model from a ``.msh`` path or a :class:`Mesh`."""
    if isinstance(mesh, str):
        ext = path.splitext(mesh)[1]
        if ext.lower() != ".msh":
            raise ValueError(f"Invalid mesh extension {ext}")
        mesh = load_gmsh(mesh)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"Invalid `mesh` type {type(mesh)}")
    residual = Residual(mesh, device=device, dtype=dtype, **kwargs)
    return transient.SolidModel(residual)


def load_fluid_model(
    mesh: np.ndarray,
    Residual: type,
    device="cpu",
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
    FluidResidual: type = flr.BernoulliAreaRatioSep,
    solid_kwargs: dict = None,
    fluid_kwargs: dict = None,
    coupling: str = "explicit",
    fluid_interface_subdomains: Sequence[str] = ("pressure",),
    device="cpu",
    dtype=config.DEFAULT_DTYPE,
) -> transient.ExplicitFSIModel:
    """Build the solid, derive the 1D fluid interface from the 'pressure'
    facet subdomain, build the fluid and couple the two explicitly."""
    if coupling != "explicit":
        raise NotImplementedError(f"coupling={coupling!r} is not ported")
    device = torch.device(device)
    solid = load_solid_model(
        solid_mesh, SolidResidual, device=device, dtype=dtype,
        **(solid_kwargs or {}),
    )
    mesh = solid.residual.mesh()
    s, dofs_fsi_solid, dofs_fsi_fluid = derive_1d_interface(
        mesh, fluid_interface_subdomains
    )
    fluid = load_fluid_model(
        s, FluidResidual, device=device, dtype=dtype, **(fluid_kwargs or {})
    )
    return transient.ExplicitFSIModel(
        solid, fluid, dofs_fsi_solid, dofs_fsi_fluid
    )
