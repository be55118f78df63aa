"""
One-call PyTorch library equivalents of the port's kernels, used only as
yardsticks: ``chip_smoke.py`` times each beside its kernel, and the tests
hold each against the kernel's plain version.  The port's solvers never
call them.

- K1 (banded gather) is a pure gather: ``torch.index_select`` on the
  flattened fields with a flat index built from the plan.
- K2 (banded scatter) is a CSR sum: ``torch.sparse.mm`` with a CSR matrix
  of ones built from the plan's own ``ptr``/``idx`` (the kernel's sums, in
  the kernel's order).
- K4 (block-banded matvec) is one CSR SpMV: ``torch.sparse.mm`` on the
  entries of the plan's matvec pattern, the ones K4 reads; K4T (its
  transpose) the same on the CSR of ``A^T`` from the transposed pattern.
- K1 and K2 on a plan stacked over shards (``banded_gather_t`` /
  ``banded_scatter_t``) are the same calls over every shard at once: one
  flat index, one block-diagonal CSR matrix.
- K3, K5 and K6 have none, nor have K3's transpose K3T, K5's backward
  K5T, the transposed sweep K6T and K6 over slabs.

``LIBRARY_CALL`` names, for each kernel, its library call or why there is
none.
"""

from __future__ import annotations

import torch

from .fem.banded import DevicePlan, _Pattern, shard_view

__all__ = [
    "LIBRARY_CALL",
    "gather_flat_index",
    "gather_index_select",
    "scatter_csr",
    "csr_mm",
    "gather_flat_index_t",
    "scatter_csr_t",
    "bsb_csr",
    "bsb_csr_t",
]

LIBRARY_CALL = {
    "gather": "torch.index_select",
    "scatter": "torch.sparse.mm (CSR of ones)",
    "bsb_matvec": "torch.sparse.mm (CSR of the pattern)",
    "ebe_matvec": "none: it gathers x[dofs] before the batched product, two"
                  " calls at least",
    "newmark": "none: three outputs (v1, a1, u_next) from one pass",
    "btd_sweep": "none: a serial recurrence over row blocks that no library"
                 " call computes on these factors",
    "btd_sweep_slabs": "none: serial recurrences over each slab's row blocks"
                       " that no library call computes on these factors",
    "gather_t": "torch.index_select",
    "scatter_t": "torch.sparse.mm (block-diagonal CSR of ones)",
    "newmark_t": "none: four vector cotangents and a reduction from one pass",
    "btd_sweep_t": "none: a serial recurrence over transposed, shifted row"
                   " blocks that no library call computes on these factors",
    "btd_sweep_t_slabs": "none: serial recurrences over each slab's transposed,"
                         " shifted row blocks that no library call computes on"
                         " these factors",
    "ebe_matvec_t": "none: it gathers x[dofs] before the batched transposed"
                    " product, two calls at least",
    "bsb_matvec_t": "torch.sparse.mm (CSR of the transposed pattern)",
}


def gather_flat_index(plan: DevicePlan, pattern: _Pattern, C: int,
                      n_cols: int):
    """``(idx, valid)``: for every entry of the gather's output
    (nv, C, ngroups*gc), its index into ``F.reshape(-1)`` of a (C, n_cols)
    ``F``, and whether it reads F at all (``delta < w`` and the column
    inside F); ``idx`` is 0 where it does not."""
    delta = pattern.delta.long()  # (ngroups, nv, gc)
    col = plan.base.long()[:, None, None] + delta
    ok = (delta < plan.w) & (col < n_cols)
    col = col.permute(1, 0, 2).reshape(plan.nv, 1, plan.ncpad)
    ok = ok.permute(1, 0, 2).reshape(plan.nv, 1, plan.ncpad)
    chan = torch.arange(C, device=col.device)[None, :, None]
    idx = torch.where(ok, chan * n_cols + col, 0)
    return idx.reshape(-1), ok.expand(plan.nv, C, plan.ncpad)


def gather_index_select(F: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The one library call: the flat gather of :func:`gather_flat_index`
    (entries that read no F come out as ``F[0, 0]``, not zero)."""
    return torch.index_select(F.reshape(-1), 0, idx)


def scatter_csr(plan: DevicePlan, pattern: _Pattern, C: int, n_rows: int,
                dtype) -> torch.Tensor:
    """CSR matrix of ones, (C * n_rows, nv * C * ncpad): row ``c * n_rows +
    n`` sums ``loc[v, c, cell]`` over the plan's CSR list of output ``n``,
    in its order, so that ``M @ loc.reshape(-1, 1)`` is the scatter."""
    ptr = pattern.ptr.long()[: n_rows + 1]
    nnz = int(ptr[-1])
    s = pattern.idx.long()[:nnz]
    v, cell = s // plan.ncpad, s % plan.ncpad
    counts = ptr[1:] - ptr[:-1]
    crow = torch.zeros(C * n_rows + 1, dtype=torch.long, device=ptr.device)
    crow[1:] = torch.cumsum(counts.repeat(C), 0)
    chan = torch.arange(C, device=ptr.device)[:, None]
    cols = (v[None, :] * C + chan) * plan.ncpad + cell[None, :]
    vals = torch.ones(C * nnz, dtype=dtype, device=ptr.device)
    return torch.sparse_csr_tensor(
        crow, cols.reshape(-1), vals,
        (C * n_rows, plan.nv * C * plan.ncpad),
    )


def gather_flat_index_t(plan: DevicePlan, pattern: _Pattern, C: int,
                        n_cols: int):
    """:func:`gather_flat_index` of a stacked plan: the index of every
    entry of the (S, nv, C, ngroups*gc) output into ``F.reshape(-1)`` of an
    (S, C, n_cols) ``F``, and whether it reads F at all."""
    which = "g" if pattern is plan.g else "s"
    idx, ok = [], []
    for s in range(plan.shards):
        view = shard_view(plan, s)
        i, k = gather_flat_index(view, getattr(view, which), C, n_cols)
        idx.append(i + s * C * n_cols)
        ok.append(k)
    return torch.cat(idx), torch.stack(ok)


def scatter_csr_t(plan: DevicePlan, pattern: _Pattern, C: int, n_rows: int,
                  dtype) -> torch.Tensor:
    """:func:`scatter_csr` of a stacked plan: the block-diagonal CSR matrix
    of ones, (S C n_rows, S nv C ncpad), of every shard's scatter (its rows
    and its locals offset by the shards before it)."""
    crows, cols = [torch.zeros(1, dtype=torch.long, device=pattern.ptr.device)], []
    for s in range(plan.shards):
        ptr = pattern.ptr[s].long()
        lo = int(ptr[0])
        ptr = ptr[: n_rows + 1] - lo
        nnz = int(ptr[-1])
        e = pattern.idx.long()[lo:lo + nnz]
        v, cell = e // plan.ncpad, e % plan.ncpad
        counts = (ptr[1:] - ptr[:-1]).repeat(C)
        crows.append(torch.cumsum(counts, 0) + crows[-1][-1])
        chan = torch.arange(C, device=e.device)[:, None]
        cols.append(((v[None, :] * C + chan) * plan.ncpad + cell[None, :]).reshape(-1)
                    + s * plan.nv * C * plan.ncpad)
    col = torch.cat(cols)
    S = plan.shards
    return torch.sparse_csr_tensor(
        torch.cat(crows), col, torch.ones(col.numel(), dtype=dtype, device=col.device),
        (S * C * n_rows, S * plan.nv * C * plan.ncpad),
    )


def csr_mm(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The one library call: ``torch.sparse.mm`` of a CSR matrix with a
    flattened dense operand, as a column."""
    return torch.sparse.mm(M, x.reshape(-1, 1))


def bsb_csr(plan, blocks: torch.Tensor, pattern) -> torch.Tensor:
    """The block-banded matrix of ``solvers.bsb`` (blocks (nblk, nb, b, b))
    as a CSR matrix (ndof, ndof) of the entries of its matvec pattern
    (``solvers.bsb.MatvecPattern``, on ``blocks``' device; zeros in it
    included), rows in order and columns ascending within each row: the
    entries K4 reads."""
    b, h, bb = plan.b, plan.h, plan.b * plan.b
    ptr, off = pattern.ptr.long(), pattern.off.long()
    rows = torch.repeat_interleave(
        torch.arange(plan.ndof, device=blocks.device), ptr[1:] - ptr[:-1])
    n = rows // b
    vals = blocks.reshape(plan.nblk, -1)[n, off]
    cols = (n + off // bb - h) * b + off % b
    return torch.sparse_csr_tensor(ptr, cols, vals, (plan.ndof, plan.ndof))


def bsb_csr_t(plan, blocks: torch.Tensor, pattern_t) -> torch.Tensor:
    """``A^T`` of the block-banded matrix as a CSR matrix (ndof, ndof) of
    the entries of its transposed pattern (``solvers.bsb.matvec_pattern_t``
    on ``blocks``' device): row ``c`` of ``A^T`` holds column ``c`` of
    ``A``, rows of ``A`` ascending, the entries K4T reads."""
    b, h, bb = plan.b, plan.h, plan.b * plan.b
    ptr, off = pattern_t.ptr.long(), pattern_t.off.long()
    cols_a = torch.repeat_interleave(
        torch.arange(plan.ndof, device=blocks.device), ptr[1:] - ptr[:-1])
    n = cols_a // b - off // bb + h
    vals = blocks.reshape(plan.nblk, -1)[n, off]
    rows_a = n * b + (off // b) % b
    return torch.sparse_csr_tensor(ptr, rows_a, vals, (plan.ndof, plan.ndof))
