"""
Static (equilibrium) solvers (counterpart of ``vf_fem_tpu.static``).

Statics come from the transient forms with v1 = a1 = 0:
``SolidModel.res_u_static`` and its Newton solve ``solve_static_u1``.  A
coupled static configuration alternates a static solid solve and a fluid
solve (Picard), or takes one transient step of dt = 1e6 from rest.
Inputs are the port's dicts (numpy arrays or tensors); states come back as
dicts of numpy arrays, with info dicts under the JAX package's keys.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .convert import to_numpy, to_tensors
from .forward import integrate_step
from .models.transient import SolidModel


def _info(info) -> dict:
    return {"num_iter": int(info.num_iter), "abs_err": float(info.abs_err),
            "rel_err": float(info.rel_err)}


def static_solid_configuration(
    model: SolidModel,
    control: dict,
    prop: dict,
    options: Optional[dict] = None,
):
    """The static configuration of a solid under ``control`` (``{'p1':
    ...}``) and ``prop``: Newton from zero.  Returns ``(state, info)``,
    ``state`` with u and zero v, a."""
    dev, dtype = model.device, model.dtype
    u_guess = torch.as_tensor(model.state0["u"], dtype=dtype, device=dev)
    with torch.no_grad():
        u1, info = model.solve_static_u1(u_guess, to_tensors(control, dev, dtype),
                                         to_tensors(prop, dev, dtype), options)
    u1 = u1.cpu().numpy()
    return {"u": u1, "v": np.zeros_like(u1), "a": np.zeros_like(u1)}, _info(info)


def static_coupled_configuration_picard(
    model,
    control: dict,
    prop: dict,
    options: Optional[dict] = None,
    max_iter: int = 50,
    abs_tol: float = 1e-8,
    rel_tol: float = 1e-11,
):
    """Fixed-point iteration over a static solid solve (under the current
    pressure) and a fluid solve (on the new geometry), from rest, until
    ``|du| + |dp|`` falls below ``abs_tol`` or ``rel_tol`` times its first
    value, or ``max_iter`` iterations ran; each iteration reads that norm
    on the host.  ``prop`` overrides the model's properties key by key.
    Returns ``(state, info)``, ``state`` the coupled state u, v = a = 0, q,
    p."""
    dev, dtype = model.device, model.dtype
    solid, fluid = model.solid, model.fluid
    prop_d = to_tensors({**model.prop, **prop}, dev, dtype)
    sl_prop, fl_prop = model._split_prop(prop_d)
    control_d = to_tensors(control, dev, dtype)
    u1 = torch.as_tensor(solid.state0["u"], dtype=dtype, device=dev)
    qp = {k: torch.zeros(np.shape(fluid.state0[k]), dtype=dtype, device=dev)
          for k in ("q", "p")}
    norm = torch.linalg.vector_norm
    info, err0 = {}, None
    with torch.no_grad():
        for it in range(max_iter):
            u1_new, _ = solid.solve_static_u1(
                u1, {"p1": model._pressure_to_solid(qp["p"])}, sl_prop, options)
            area = model._area_from_u1(u1_new, prop_d)
            qp_new = fluid.solve_pure({"area": area, **control_d}, fl_prop, qp)
            err = float(norm(u1_new - u1)) + float(norm(qp_new["p"] - qp["p"]))
            u1, qp = u1_new, qp_new
            if err0 is None:
                err0 = err if err else 1.0
            info = {"num_iter": it + 1, "abs_err": err, "rel_err": err / err0}
            if err < abs_tol or err < rel_tol * err0:
                break
    u1 = u1.cpu().numpy()
    zero = np.zeros_like(u1)
    return {"u": u1, "v": zero, "a": zero.copy(), **to_numpy(qp)}, info


def static_coupled_configuration_newton(
    model,
    control: dict,
    prop: dict,
    options: Optional[dict] = None,
):
    """A static coupled configuration as one transient step of dt = 1e6
    (the Newmark terms vanish) from a zero state
    (``forward.integrate_step``).  Returns ``(state, info)``."""
    state0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    return integrate_step(model, state0, control, prop, 1e6, options)
