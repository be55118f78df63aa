"""DOF-sharded stepping (counterpart of ``vf_fem_tpu.parallel``'s
``ddstep`` and ``spike_shard``; SPIKE with one slab a shard is
``solvers.spike`` on the stacked slabs).

The JAX package runs the S shards as one ``shard_map`` program over S
devices.  Here the S shards are stacked on one device: every per-shard
array has a leading shard axis S, and the collectives are tensor operations
along it (:mod:`.shards`).  ``parallel.sweep``, ``domain`` and ``bsb_shard``
are not ported (ROADMAP item 22).
"""

__all__ = ["DDIntegrator", "plan_dd", "plan_dd_banded"]


def __getattr__(name):
    if name in __all__:
        from . import ddstep

        return getattr(ddstep, name)
    raise AttributeError(name)
