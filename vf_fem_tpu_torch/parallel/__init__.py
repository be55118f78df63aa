"""Batched parameter sweeps and DOF-sharded stepping (counterpart of
``vf_fem_tpu.parallel``'s ``sweep``, ``ddstep`` and ``spike_shard``; SPIKE
with one slab a shard is ``solvers.spike`` on the stacked slabs).

:mod:`.sweep` integrates a batch of property (and control) variants of one
model as one batched run, each kernel launched once a step for the whole
batch, on the model's device (its split over a mesh of several devices is
not ported).

The JAX package runs the S shards of the DOF-sharded step as one
``shard_map`` program over S devices.  Here the S shards are stacked on one
device: every per-shard array has a leading shard axis S, and the
collectives are tensor operations along it (:mod:`.shards`).  ``domain``
and ``bsb_shard`` are not ported (ROADMAP item 22).
"""

_SWEEP = ("batch_mesh", "stack_props", "sweep_integrate", "sweep_grad")
_DD = ("DDIntegrator", "plan_dd", "plan_dd_banded")
__all__ = [*_SWEEP, *_DD]


def __getattr__(name):
    if name in _SWEEP:
        from . import sweep

        return getattr(sweep, name)
    if name in _DD:
        from . import ddstep

        return getattr(ddstep, name)
    raise AttributeError(name)
