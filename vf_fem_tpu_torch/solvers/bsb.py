"""
Block-banded (BSB) storage of the Newmark Jacobian for large meshes
(counterpart of ``vf_fem_tpu.solvers.bsb``).

After a reverse Cuthill–McKee renumbering (``mesh.reorder.rcm_mesh``) a P1
mesh Jacobian has a dof bandwidth of O(sqrt(ndof)).  Dofs are grouped into
blocks of ``b = 128``; block row ``n`` couples only to block columns
``n-h .. n+h`` (``h = ceil(bandwidth / b)``), stored as
``blocks[nblk, nb, b, b]`` with ``nb = 2h + 1``.  The matvec is

    y_n = sum_m  blocks[n, m] @ xpad[(n+m)*b : (n+m+1)*b]

(``ops.bsb_matvec``: kernel K4 on CUDA, the plain version on the CPU).

The block array is filled from the per-element Jacobian blocks by one
scatter-add per refresh, through a :class:`~..fem.assembly.ScatterPlan`
(deterministic: a fixed summation order on every device and run).  The
plan is the JAX package's, with identical arrays.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..fem.assembly import ScatterPlan

__all__ = ["BSBPlan", "plan_bsb", "fill_plan", "bsb_fill"]


class BSBPlan(NamedTuple):
    """Static (host-built) plan for block-banded assembly and matvec."""

    ndof: int
    b: int  # block size
    nblk: int  # number of block rows
    nb: int  # neighbour blocks per block row (2h+1)
    h: int  # half-band in blocks
    # flat index into blocks[nblk, nb, b, b] of every (element, i, j)
    # source entry; entries with src_keep False (Dirichlet rows) add zero
    # and identity rows are installed at diag_ones
    tgt_idx: np.ndarray  # (n_src,) int32
    src_keep: np.ndarray  # (n_src,) bool
    bc_dofs: np.ndarray
    diag_ones: np.ndarray  # flat block indices of the Dirichlet 1.0 entries


def plan_bsb(dofs_arrays: Sequence[np.ndarray], ndof: int, bc_dofs,
             b: int = 128) -> BSBPlan:
    """Build the plan from element dof maps (cells, then facets); entries
    in Dirichlet rows are dropped and identity rows installed instead.
    Raises ``ValueError`` if an entry falls outside the band."""
    rows, cols = [], []
    for d in dofs_arrays:
        if d is None or d.size == 0:
            continue
        d = np.asarray(d)
        ne, nld = d.shape
        rows.append(np.broadcast_to(d[:, :, None], (ne, nld, nld)).reshape(-1))
        cols.append(np.broadcast_to(d[:, None, :], (ne, nld, nld)).reshape(-1))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)

    bw = int(np.abs(rows - cols).max())
    h = -(-bw // b)
    nb = 2 * h + 1
    nblk = -(-ndof // b)
    if ndof > 4 * b and nb * b > max(ndof // 4, 4 * b):
        warnings.warn(
            f"plan_bsb: realized dof bandwidth {bw} gives a band of"
            f" {nb} blocks x {b} = {nb * b} columns (~{nb * b / ndof:.0%}"
            f" of ndof {ndof}) -- the banded format is degenerating"
            " toward dense.  RCM-renumber the mesh first"
            " (mesh.reorder.rcm_mesh / loader reorder='rcm')",
            RuntimeWarning,
        )

    blk_r = rows // b
    blk_c = cols // b
    m = blk_c - blk_r + h
    if not ((m >= 0) & (m < nb)).all():
        raise ValueError(
            f"bandwidth {bw} inconsistent with block plan; renumber the mesh"
            " (mesh.reorder.rcm_mesh) before building the model"
        )
    tgt = ((blk_r * nb + m) * b + (rows - blk_r * b)) * b + (cols - blk_c * b)

    bc = np.zeros(ndof, dtype=bool)
    bc[np.asarray(bc_dofs)] = True
    keep = ~bc[rows]

    bcd = np.asarray(bc_dofs)
    blk = bcd // b
    i = bcd - blk * b
    diag_ones = ((blk * nb + h) * b + i) * b + i

    return BSBPlan(
        ndof=ndof, b=b, nblk=nblk, nb=nb, h=h,
        tgt_idx=tgt.astype(np.int32),
        src_keep=keep,
        bc_dofs=np.asarray(bc_dofs, dtype=np.int32),
        diag_ones=diag_ones.astype(np.int32),
    )


class DeviceFill(NamedTuple):
    """What :func:`bsb_fill` needs on the device."""

    scatter: ScatterPlan  # element entries -> flat block array
    keep: torch.Tensor  # (n_src,) bool
    diag_ones: torch.Tensor  # (n_bc,) int64


def fill_plan(plan: BSBPlan, device) -> DeviceFill:
    size = plan.nblk * plan.nb * plan.b * plan.b
    return DeviceFill(
        scatter=ScatterPlan(plan.tgt_idx[:, None], size, device),
        keep=torch.as_tensor(plan.src_keep, device=device),
        diag_ones=torch.as_tensor(plan.diag_ones.astype(np.int64),
                                  device=device),
    )


def bsb_fill(plan: BSBPlan, fill: DeviceFill,
             J_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """The block array (nblk, nb, b, b) from per-element Jacobian blocks
    (in the order of the plan's dof arrays); Dirichlet rows get identity."""
    src = torch.cat([J.reshape(-1) for J in J_list
                     if J is not None and J.numel()])
    src = torch.where(fill.keep, src, 0.0)
    flat = fill.scatter(src[:, None])
    # each Dirichlet dof appears once: a plain indexed add is deterministic
    flat[fill.diag_ones] += 1.0
    return flat.reshape(plan.nblk, plan.nb, plan.b, plan.b)

