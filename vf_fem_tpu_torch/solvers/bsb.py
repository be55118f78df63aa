"""
Block-banded (BSB) storage of the Newmark Jacobian for large meshes
(counterpart of ``vf_fem_tpu.solvers.bsb``).

After a reverse Cuthill–McKee renumbering (``mesh.reorder.rcm_mesh``) a P1
mesh Jacobian has a dof bandwidth of O(sqrt(ndof)).  Dofs are grouped into
blocks of ``b = 128``; block row ``n`` couples only to block columns
``n-h .. n+h`` (``h = ceil(bandwidth / b)``), stored as
``blocks[nblk, nb, b, b]`` with ``nb = 2h + 1``.  The matvec is

    y_n = sum_m  blocks[n, m] @ xpad[(n+m)*b : (n+m+1)*b]

(``ops.bsb_matvec``: kernel K4 on CUDA, the plain version on the CPU),
and its transpose ``y = A^T x`` of the adjoint solves is
``ops.bsb_matvec_t`` (kernel K4T).

The block array is filled from the per-element Jacobian blocks by one
scatter-add per refresh, through a :class:`~..fem.assembly.ScatterPlan`
(deterministic: a fixed summation order on every device and run).  The
plan is the JAX package's, with identical arrays.

The band is almost all zeros (2.1% of it can be written at 23.7k dofs).
``bsb_fill`` writes only the plan's targets and the Dirichlet ones, into
an array that starts from zeros, so ``blocks`` is zero outside the
:class:`MatvecPattern` of those entries, and K4 reads only them, by row
(:func:`matvec_pattern`); K4T reads the same entries by column
(:func:`matvec_pattern_t`).
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..fem.assembly import ScatterPlan

__all__ = ["BSBPlan", "MatvecPattern", "plan_bsb", "matvec_pattern",
           "matvec_pattern_t", "fill_plan", "bsb_fill"]


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


class MatvecPattern(NamedTuple):
    """The entries :func:`bsb_fill` can write (``tgt_idx[src_keep]`` and
    ``diag_ones``), by output row: CSR with columns ascending in each row.
    Entry ``k`` of row ``r`` (block row ``n = r // b``) is stored as its
    offset ``off[k]`` into the band of block row ``n``,
    ``blocks[n].reshape(-1)``: ``off = (m b + r % b) b + q`` for block
    column ``m`` and column ``q`` within it, so that its column is
    ``(n + m - h) b + q``.  Host arrays from :func:`matvec_pattern`,
    tensors on the device in :class:`DeviceFill`."""

    ptr: np.ndarray  # (ndof + 1,) int32 row pointers
    off: np.ndarray  # (nnz,) int32, below nb * b * b


def _pattern_entries(plan: BSBPlan):
    """Every entry :func:`bsb_fill` can write, as (offset into the band of
    its block row, row, column)."""
    b, nb = plan.b, plan.nb
    flat = np.union1d(plan.tgt_idx[plan.src_keep].astype(np.int64),
                      plan.diag_ones.astype(np.int64))
    n, off = np.divmod(flat, nb * b * b)
    m, rest = np.divmod(off, b * b)
    i, q = np.divmod(rest, b)
    return off, n * b + i, (n + m - plan.h) * b + q


def _csr(plan: BSBPlan, major, minor, off) -> MatvecPattern:
    order = np.lexsort((minor, major))
    ptr = np.zeros(plan.ndof + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(np.bincount(major, minlength=plan.ndof))
    return MatvecPattern(ptr=ptr.astype(np.int32),
                         off=off[order].astype(np.int32))


def matvec_pattern(plan: BSBPlan) -> MatvecPattern:
    """K4's pattern of ``plan`` (host arrays)."""
    off, rows, cols = _pattern_entries(plan)
    return _csr(plan, rows, cols, off)


def matvec_pattern_t(plan: BSBPlan) -> MatvecPattern:
    """K4T's pattern of ``plan`` (host arrays): the same entries as
    :func:`matvec_pattern`, CSR by column with rows ascending in each
    column.  Each offset is into the band of its row's block row, as in
    K4's; with the column ``c`` it gives the row: block column ``m = off //
    b^2``, block row ``n = c // b - m + h``, row ``n b + (off // b) % b``."""
    off, rows, cols = _pattern_entries(plan)
    return _csr(plan, cols, rows, off)


def _on_device(pattern: MatvecPattern, device) -> MatvecPattern:
    return MatvecPattern(*(torch.as_tensor(a, device=device) for a in pattern))


class DeviceFill:
    """What :func:`bsb_fill` needs on the device, and the patterns of what
    it writes as tensors: K4's by row, built with the fill, and K4T's by
    column, built on first use (only the transposed solve of a 'bsb'
    adjoint reads it) and kept."""

    def __init__(self, plan: BSBPlan, device):
        size = plan.nblk * plan.nb * plan.b * plan.b
        self._plan, self._device = plan, device
        # element entries -> flat block array
        self.scatter = ScatterPlan(plan.tgt_idx[:, None], size, device)
        self.keep = torch.as_tensor(plan.src_keep, device=device)
        self.diag_ones = torch.as_tensor(plan.diag_ones.astype(np.int64),
                                         device=device)
        self.pattern = _on_device(matvec_pattern(plan), device)

    @functools.cached_property
    def pattern_t(self) -> MatvecPattern:
        return _on_device(matvec_pattern_t(self._plan), self._device)


def fill_plan(plan: BSBPlan, device) -> DeviceFill:
    return DeviceFill(plan, device)


def bsb_fill(plan: BSBPlan, fill: DeviceFill,
             J_list: Sequence[torch.Tensor], identity: bool = True) -> torch.Tensor:
    """The block array (nblk, nb, b, b) from per-element Jacobian blocks
    (in the order of the plan's dof arrays); Dirichlet rows get identity
    (zero with ``identity=False``).  It is zero outside ``fill.pattern``:
    the scatter starts from zeros and writes only the plan's targets.
    Blocks with a leading batch axis, (B, ne, nld, nld), fill a batch of
    arrays (B, nblk, nb, b, b): one scatter of the B columns."""
    Js = [J for J in J_list if J is not None and J.numel()]
    lead = Js[0].shape[:-3]  # () or (B,)
    src = torch.cat([J.reshape(lead + (-1,)) for J in Js], dim=-1)
    src = torch.where(fill.keep, src, 0.0)
    flat = fill.scatter(src.T[:, None]).T if lead else fill.scatter(src[:, None])
    if identity:
        # each Dirichlet dof appears once: a plain indexed add is deterministic
        flat[..., fill.diag_ones] += 1.0
    return flat.reshape(lead + (plan.nblk, plan.nb, plan.b, plan.b))

