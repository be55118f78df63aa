"""
A numpy emulation of the summation order of K4 and K4T (``csrc/ops.cu``:
``bsb_matvec_kernel``, ``bsb_matvec_t_kernel``), for the CPU tests and, on
the card, as the kernels' bit-level reference.

Output ``r`` of ``y`` sums the products of its pattern entries (CSR order:
columns ascending for K4's rows, rows ascending for K4T's columns) over
``lanes`` lanes: lane ``l`` adds the products of entries ``l, l + lanes,
l + 2 lanes, ...`` in that order to a sum that starts at +0, then the
lanes' sums meet in the kernel's xor tree (``d = lanes/2, ..., 1``: every
lane adds lane ``l ^ d``'s sum).  Each product and each sum is rounded
once in the working type, as the kernel's ``_rn`` intrinsics round them.  A
lane with fewer entries adds +0 here, which changes no sum: a
round-to-nearest sum that starts at +0 is never -0.
"""

import numpy as np


def _lane_sums(n_out: int, out: np.ndarray, pos: np.ndarray, prod: np.ndarray,
               lanes: int) -> np.ndarray:
    """The kernels' order: entry ``k`` (product ``prod[k]``) is the
    ``pos[k]``-th of output ``out[k]``."""
    dtype = prod.dtype
    steps = int(pos.max()) // lanes + 1 if pos.size else 0
    P = np.zeros((n_out, lanes, steps), dtype=dtype)
    P[out, pos % lanes, pos // lanes] = prod
    acc = np.zeros((n_out, lanes), dtype=dtype)
    for s in range(steps):
        acc = acc + P[:, :, s]
    lane = np.arange(lanes)
    d = lanes // 2
    while d:
        acc = acc + acc[:, lane ^ d]
        d //= 2
    return acc[:, 0]


def emulate_bsb_matvec(plan, pattern, blocks: np.ndarray, x: np.ndarray,
                       lanes: int) -> np.ndarray:
    """K4's ``y`` for ``blocks`` (nblk, nb, b, b) and ``x`` (ndof,) of one
    float dtype, with ``pattern`` (``solvers.bsb.MatvecPattern``, numpy or
    CPU tensors) and ``lanes`` lanes a row."""
    b, ndof = plan.b, plan.ndof
    ptr = np.asarray(pattern.ptr, dtype=np.int64)
    off = np.asarray(pattern.off, dtype=np.int64)
    rows = np.repeat(np.arange(ndof), ptr[1:] - ptr[:-1])
    n = rows // b
    cols = (n + off // (b * b) - plan.h) * b + off % b
    prod = blocks.reshape(plan.nblk, -1)[n, off] * x[cols]
    return _lane_sums(ndof, rows, np.arange(off.size) - ptr[rows], prod, lanes)


def emulate_bsb_matvec_t(plan, pattern_t, blocks: np.ndarray,
                         x: np.ndarray, lanes: int) -> np.ndarray:
    """K4T's ``y = A^T x`` with ``pattern_t`` (``solvers.bsb.matvec_pattern_t``:
    CSR by column, each offset into the band of its row's block row) and
    ``lanes`` lanes a column, in K4's order on the column's entries."""
    b, ndof = plan.b, plan.ndof
    ptr = np.asarray(pattern_t.ptr, dtype=np.int64)
    off = np.asarray(pattern_t.off, dtype=np.int64)
    cols = np.repeat(np.arange(ndof), ptr[1:] - ptr[:-1])
    n = cols // b - off // (b * b) + plan.h
    rows = n * b + (off // b) % b
    prod = blocks.reshape(plan.nblk, -1)[n, off] * x[rows]
    return _lane_sums(ndof, cols, np.arange(off.size) - ptr[cols], prod, lanes)
