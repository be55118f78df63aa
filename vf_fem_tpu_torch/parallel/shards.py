"""
The collectives of the DOF-sharded step on shards stacked on one device.

The JAX package runs one ``shard_map`` program over S devices and moves
data between them with ``ppermute``, ``psum`` and ``all_gather``
(``vf_fem_tpu/parallel/ddstep.py:575-586``,
``vf_fem_tpu/parallel/spike_shard.py:75-97``).  With the S shards stacked
along a leading axis of one tensor, each becomes a tensor operation along
that axis, and an ``all_gather`` is the stacked tensor itself (so SPIKE's
reduced system and interface exchange are ``solvers.spike``'s own on the
stacked slabs); no module of the JAX package is its counterpart.  A shard
past either end receives zeros, as ``ppermute`` gives a device no
permutation sends to.
"""

from __future__ import annotations

import torch

__all__ = ["halo_right", "spill_add", "pnorm", "shift_from_prev",
           "shift_from_next"]


def shift_from_prev(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Each shard receives the previous shard's ``x[s]`` (shard 0 zeros);
    the shard axis is ``dim``."""
    n = x.shape[dim]
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)), x.narrow(dim, 0, n - 1)], dim)


def shift_from_next(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Each shard receives the next shard's ``x[s]`` (the last one zeros);
    the shard axis is ``dim``."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, n - 1), torch.zeros_like(x.narrow(dim, 0, 1))], dim)


def halo_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` entries (axis 1) of the next shard's ``x``."""
    return shift_from_next(x[:, :n])


def spill_add(buf: torch.Tensor, n_loc: int) -> torch.Tensor:
    """``buf`` (S, n_loc + H, ...): each shard ships its tail past
    ``n_loc`` to the next shard, which adds it into its first H entries."""
    head = buf[:, :n_loc].clone()
    spill = buf.shape[1] - n_loc
    head[:, :spill] += shift_from_prev(buf[:, n_loc:])
    return head


def pnorm(v: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a sharded vector (S, n): each shard's sum of squares,
    then their sum over the shards (``psum``)."""
    return torch.sqrt(torch.sum(torch.sum(v * v, dim=1)))
