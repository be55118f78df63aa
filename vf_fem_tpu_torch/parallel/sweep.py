"""
Batched parameter sweeps (counterpart of ``vf_fem_tpu.parallel.sweep``):
many property variants (and control variants) of one model, integrated as
one batched program.

The reference runs such a study serially, one variant after another
(reference ``models/fsi.py:38-39``).  The JAX package ``vmap``s
``integrate_pure`` over a leading batch axis and shards that axis over a
device mesh.  Here a batch steps as one batched run on the model's device
(``forward.integrate_batch_pure``): each step launches each kernel once
for the whole batch (K5 over all B n entries, K1/K2 over the batch's
channels with ``assembly='banded'``), a fixed-iteration run with refresh
windows replays one captured CUDA graph of the batched step, and an
adaptive run steps every variant in lockstep, each variant stopping by its
own test.  The JAX package shards the batch axis over the devices of a
mesh; that split is not ported: a model lives on one device, so ``mesh``
may only name the model's device (once or more), and the batch runs as
one chunk there.  On one card that is the JAX package's split too.

This is BASELINE config 5: "256 vmapped M5 geometry/stiffness variants".
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from .. import forward
from ..convert import to_tensors

# the default assembly of a sweep's residual; the JAX package pins 'plain'
# from a TPU measurement, this one is the faster of the two on an H100 at
# 64 variants of M5 (PERF.md, chip_smoke.py phase 19)
ASSEMBLY = "plain"


def batch_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> list:
    """The devices of a sweep's mesh: the first ``n_devices`` of
    ``devices`` (by default every CUDA device; raises where there is
    none).  Pass ``devices`` for others, such as CPU devices.  A sweep
    takes only a mesh of its model's device (see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("batch_mesh: no CUDA device (pass devices= for others)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    return devices[: n_devices or len(devices)]


def stack_props(props: list) -> dict:
    """Stack a list of property dicts (of arrays or tensors) into one dict
    with a leading batch axis, in the first dict's key order: tensors where
    any entry is one, else numpy arrays."""
    dicts = [p.to_dict() if hasattr(p, "to_dict") else dict(p) for p in props]

    def stack(vals):
        if any(isinstance(v, torch.Tensor) for v in vals):
            return torch.stack([torch.as_tensor(v) for v in vals])
        return np.stack([np.asarray(v) for v in vals])

    return {k: stack([d[k] for d in dicts]) for k in dicts[0]}


def _check_mesh(model, mesh) -> None:
    """A mesh (:func:`batch_mesh`) may only name the model's device: a
    split of the batch over several devices is not ported."""
    for dev in mesh or ():
        if torch.device(dev) != model.device:
            raise NotImplementedError(
                f"a sweep over {dev} is not ported: the model is on {model.device}, and a"
                f" mesh over several devices needs a model on each")


def _params(params: Optional[dict]) -> dict:
    return {"assembly": ASSEMBLY, **(params or {})}


def sweep_integrate(
    model,
    ini_state: dict,
    controls_stacked: dict,
    prop_batch: dict,
    times,
    params: Optional[dict] = None,
    mesh=None,
    batch_controls: bool = False,
):
    """Integrate a batch of property variants (and, with
    ``batch_controls``, of control variants) of ``model`` at once.

    ``prop_batch`` has a leading batch axis on every entry (so has
    ``controls_stacked`` with ``batch_controls``); ``ini_state`` is every
    variant's.  Returns ``(fin, infos)``: the final states (B, ...) and the
    ``SolveInfo`` of every step, (B, n_steps) tensors.  Row b equals
    ``forward.integrate_pure`` of variant b alone (to the rounding of
    batched products).  ``assembly`` is :data:`ASSEMBLY` unless
    ``params`` sets it.  ``mesh`` (:func:`batch_mesh`): None or the
    model's device (see the module docstring)."""
    _check_mesh(model, mesh)
    fin, _, info = forward.integrate_batch_pure(
        model, ini_state, controls_stacked, prop_batch, times, _params(params),
        batch_controls)
    return fin, info


def sweep_grad(
    model,
    functional: Callable,
    ini_state: dict,
    controls_stacked: dict,
    prop_batch: dict,
    times,
    params: Optional[dict] = None,
    mesh=None,
):
    """Each variant's value of the scalar trajectory functional
    ``functional(traj, controls_stacked, prop, times)`` (of one variant's
    trajectory, (n_steps, ...) tensors, and properties) and its gradient
    with respect to the variant's properties: ``(values, grads)``, (B,) and
    a dict of (B, ...) tensors.

    The JAX package takes ``vmap(value_and_grad(loss))``.  Here the batch
    runs the differentiable batched loop once (``forward.
    integrate_batch_pure`` on properties that require grad; the IFT rule of
    each step solves every variant's adjoint at once), ``functional`` is
    vmapped over its trajectories, and one reverse pass of the sum of the
    values gives every variant's gradient: a variant's value depends on its
    own properties only.  ``assembly`` and ``mesh`` as
    :func:`sweep_integrate`."""
    _check_mesh(model, mesh)
    dev, dtype = model.device, model.dtype
    controls = to_tensors(controls_stacked, dev, dtype)
    times_t = torch.as_tensor(np.asarray(times, dtype=np.float64), device=dev)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in to_tensors(prop_batch, dev, dtype).items()}
    with torch.enable_grad():
        _, traj, _ = forward.integrate_batch_pure(model, ini_state, controls, leaves,
                                                  np.asarray(times), _params(params))
        vals = vmap(functional, in_dims=(0, None, 0, None))(traj, controls, leaves, times_t)
        g = torch.autograd.grad(vals.sum(), list(leaves.values()), allow_unused=True)
    return vals.detach(), {k: torch.zeros_like(v) if gk is None else gk
                           for (k, v), gk in zip(leaves.items(), g)}
