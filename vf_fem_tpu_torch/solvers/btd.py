"""
Block-tridiagonal direct solver over the block-banded Jacobian
(counterpart of ``vf_fem_tpu.solvers.btd``).

The block-banded operator (``solvers.bsb``, half-band ``h`` blocks of
``b = 128``) is exactly block-tridiagonal in super-blocks of ``Bt = h*b``:
super-row ``i`` couples only to ``i-1, i, i+1``.  A block-Thomas
factorization (sequential Schur complements ``S_i = D_i - L_i S_{i-1}^-1
U_{i-1}``, inverses stored explicitly) then solves the system directly:

- factorization: ``n_sup`` sequential ``Bt x Bt`` inverses and batched
  matmuls, once per Jacobian refresh window;
- solve: one batched matmul (``g = Sinv r``) and two sweeps of one block
  matvec per row over the product-form factors ``V = Sinv L`` and
  ``W = Sinv U`` (:class:`BTDFactors`).  Each sweep is one launch of the
  block-Thomas sweep kernel K6 on CUDA tensors (``ops.btd_sweep``).

The transposed solve :func:`btd_solve_t` (the adjoint of a step) reads
the same factors through the transposed sweep kernel K6T
(``ops.btd_sweep_t``).

A batch of variants (``parallel.sweep``) factors and solves with a
leading batch axis on the blocks, the factors and the vectors: each serial
row of the factorization is one batched ``solve_ex`` and one batched
product over the batch, and each sweep one launch of K6 (K6T) over the
batch's chains, one cluster a variant.

Requires an RCM-renumbered mesh like ``bsb``; used through
``linear_solver='btd'``.  The factors may be stored below the blocks'
precision (``store_dtype`` bf16, e4m3 or e5m2 for ``Sinv``,
``offdiag_dtype`` for ``V`` and ``W``), and factored in f32 under f64
residuals (``factor_dtype='float32'``): :func:`btd_factor`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import ops
from .bsb import BSBPlan

__all__ = ["BTDFactors", "btd_factor", "btd_solve", "btd_solve_t",
           "btd_superblocks"]

# storage dtypes of the factors, by the JAX package's names
STORE_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}
# the dtype a Jacobian may be factored in below its own (``factor_dtype``)
FACTOR_DTYPES = {"float32": torch.float32}
# the largest finite value of each fp8 storage dtype: a cast clamps to it
# first (``vf_fem_tpu.solvers.btd._FP8_MAX``)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _dtype(name, table, what):
    """The torch dtype of a storage or factor dtype given by the JAX
    package's name (None stays None); raises ``ValueError`` naming every
    supported one."""
    if name is None:
        return None
    if name not in table:
        raise ValueError(f"{what} {name!r} is not supported ({tuple(table)})")
    return table[name]


def store_cast(X: torch.Tensor, store_dtype) -> torch.Tensor:
    """``X`` cast to the storage dtype (a name of ``STORE_DTYPES``; None
    leaves it), clamped first to the finite range of an fp8 one, so that an
    outlier saturates rather than overflowing to inf or NaN (the JAX
    package's ``_store_cast``)."""
    dt = _dtype(store_dtype, STORE_DTYPES, "store_dtype")
    if dt is None:
        return X
    fmax = FP8_MAX.get(dt)
    if fmax is not None:
        X = X.clamp(-fmax, fmax)
    return X.to(dt)


class BTDFactors(NamedTuple):
    """Product-form block-Thomas factors.

    The factorization is ``A_s = Lt Ut`` (``Lt`` lower block-bidiagonal
    with diagonal ``S_i`` and sub-diagonal ``L_i``; ``Ut`` upper
    bidiagonal with unit diagonal and super ``Sinv_i U_i``).  The products
    ``V_i = Sinv_i L_i`` and ``W_i = Sinv_i U_i`` are stored, so each solve
    sweep takes one matvec per sequential block row
    (``y_i = g_i - V_i y_{i-1}``, ``x_i = y_i - W_i x_{i+1}``) with the
    ``Sinv`` application hoisted out as one batched matmul (``g = Sinv r``).
    """

    Sinv: torch.Tensor  # (..., n_sup, Bt, Bt) Schur-complement inverses
    V: torch.Tensor  # (..., n_sup, Bt, Bt) products Sinv_i @ L_i
    W: torch.Tensor  # (..., n_sup, Bt, Bt) products Sinv_i @ U_i
    d: torch.Tensor  # (..., nblk * b) Jacobi equilibration scale


def _btd_from_bsb(plan: BSBPlan, blocks: torch.Tensor):
    """Regroup band blocks (..., nblk, nb, b, b) into block-tridiagonal
    (D, L, U) super-blocks (..., n_sup, Bt, Bt); identity rows pad the last
    super-row when ``n_sup * h > nblk``."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    dev = blocks.device
    lead = blocks.shape[:-4]
    n_sup = -(-nblk // h)
    pad = n_sup * h - nblk
    if pad:
        # identity padding rows keep the factorization nonsingular
        eye_rows = blocks.new_zeros(lead + (pad, nb, b, b))
        eye_rows[..., h, :, :] = torch.eye(b, dtype=blocks.dtype, device=dev)
        blocks = torch.cat([blocks, eye_rows], dim=-4)

    rr, cc = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    n_idx = torch.as_tensor(h * np.arange(n_sup)[:, None, None] + rr[None],
                            device=dev)

    def gather(m_grid, mask):
        m = torch.as_tensor(np.clip(m_grid, 0, nb - 1), device=dev)
        sub = blocks[..., n_idx, m[None], :, :]  # (..., n_sup, h, h, b, b)
        sub = sub * torch.as_tensor(mask, dtype=blocks.dtype,
                                    device=dev)[:, :, None, None]
        # (..., n_sup, h, h, b, b) -> (..., n_sup, h*b, h*b); contiguous: the
        # index of a batch's inner axes lays its result out in another
        # order, which the factors' buffers (empty_like) would inherit
        return sub.transpose(-3, -2).reshape(lead + (n_sup, h * b, h * b)).contiguous()

    ones = np.ones((h, h), dtype=bool)
    D = gather(h + cc - rr, ones)
    U = gather(2 * h + cc - rr, cc <= rr)
    L = gather(cc - rr, cc >= rr)
    return D, L, U


def _equilibration(plan: BSBPlan, blocks: torch.Tensor) -> torch.Tensor:
    diag = torch.diagonal(blocks[..., plan.h, :, :], dim1=-2, dim2=-1)  # (..., nblk, b)
    return torch.sqrt(torch.abs(diag) + 1e-30).flatten(-2)


def _scale_blocks(plan: BSBPlan, blocks: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """blocks <- D^-1/2 A D^-1/2 in band storage."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    dr = d.unflatten(-1, (nblk, b))
    # column scale for band position m: block column n + m - h (clamped;
    # the out-of-range positions hold zero blocks, so the value is moot)
    col_idx = np.clip(
        np.arange(nblk)[:, None] + np.arange(nb)[None, :] - h, 0, nblk - 1
    )
    dc = dr[..., torch.as_tensor(col_idx, device=d.device), :]  # (..., nblk, nb, b)
    return blocks / dr[..., :, None, :, None] / dc[..., :, :, None, :]


def btd_superblocks(plan: BSBPlan, blocks: torch.Tensor):
    """Equilibrate the banded Jacobian (a leading batch axis or none) and
    regroup it into block-tridiagonal super-blocks: ``(D, L, U, d)``."""
    d = _equilibration(plan, blocks)
    blocks_s = _scale_blocks(plan, blocks, d)
    # the trailing pad rows of the last block (beyond ndof) are all-zero;
    # a direct factorization needs identity rows there (in the scaled
    # space)
    tail_start = plan.ndof - (plan.nblk - 1) * plan.b
    if tail_start < plan.b:
        last = blocks_s[..., plan.nblk - 1, plan.h, :, :]
        last.diagonal(dim1=-2, dim2=-1)[..., tail_start:] += 1.0
    D, L, U = _btd_from_bsb(plan, blocks_s)
    return D, L, U, d


def thomas_factor(D: torch.Tensor, L: torch.Tensor, U: torch.Tensor,
                  what: str):
    """The serial block-Thomas loop of :func:`btd_factor` and of
    ``solvers.cbtd.cbtd_factor`` on block-tridiagonal super-blocks
    ``(D, L, U)`` (..., n_sup, Bt, Bt): the Schur-complement inverses
    ``Sinv_i = (D_i - L_i W_{i-1})^-1`` and the products ``V = Sinv L``,
    ``W = Sinv U``.

    The ``n_sup`` inverses are ``torch.linalg.solve_ex`` calls, each over
    the leading axes at once (a batch of variants: one batched call and
    one batched product a row), whose ``info`` is read once after the loop
    (raises, naming ``what``, if a Schur complement is singular), not once
    per row."""
    n_sup, Bt = D.shape[-3], D.shape[-1]
    eye = torch.eye(Bt, dtype=D.dtype, device=D.device).expand(D.shape[:-3] + (Bt, Bt))
    Sinv = torch.empty_like(D)
    W = torch.empty_like(D)
    infos = []
    for i in range(n_sup):
        if i == 0:
            S = D[..., 0, :, :]
        else:
            # SU = Sinv_{i-1} @ U_{i-1} is W_{i-1}: the W products fall
            # out of the factorization
            W[..., i - 1, :, :] = Sinv[..., i - 1, :, :] @ U[..., i - 1, :, :]
            S = D[..., i, :, :] - L[..., i, :, :] @ W[..., i - 1, :, :]
        Sinv[..., i, :, :], info = torch.linalg.solve_ex(S, eye)
        infos.append(info)
    W[..., -1, :, :] = Sinv[..., -1, :, :] @ U[..., -1, :, :]
    bad = torch.nonzero(torch.stack(infos, dim=-1))
    if bad.numel():
        where = (f"super-rows {bad.flatten().tolist()}" if D.dim() == 3
                 else f"(variant, super-row) {bad.tolist()}")
        raise RuntimeError(f"{what}: singular Schur complement at {where}")
    # V = Sinv @ L as one batched matmul, outside the serial loop
    V = Sinv @ L
    return Sinv, V, W


def check_dtypes(store_dtype=None, factor_dtype=None, offdiag_dtype=None):
    """Raise ``ValueError`` (naming what is supported) unless each of the
    three dtype options is None or supported."""
    _dtype(store_dtype, STORE_DTYPES, "btd_factor: store_dtype")
    _dtype(offdiag_dtype, STORE_DTYPES, "btd_factor: offdiag_dtype")
    _dtype(factor_dtype, FACTOR_DTYPES, "btd_factor: factor_dtype")


def factor_blocks(blocks: torch.Tensor, factor_dtype=None) -> torch.Tensor:
    """The blocks in the dtype they are factored in: ``factor_dtype``
    ('float32') casts them before the factorization, whose products and
    solves then run in f32 under the f64 residuals (the JAX package's
    mixed-precision path)."""
    dt = _dtype(factor_dtype, FACTOR_DTYPES, "btd_factor: factor_dtype")
    return blocks if dt is None else blocks.to(dt)


def btd_factor(plan: BSBPlan, blocks: torch.Tensor, store_dtype=None,
               factor_dtype=None, offdiag_dtype=None) -> BTDFactors:
    """Equilibrate and block-Thomas factor the banded Jacobian, in the
    blocks' dtype, or in ``factor_dtype`` ('float32': the blocks are cast
    before factoring; the solve's vectors stay in the residual's dtype).

    ``store_dtype`` ('bfloat16', 'float8_e4m3fn', 'float8_e5m2') stores
    ``Sinv``, ``V`` and ``W`` below that precision (the solve streams them);
    ``offdiag_dtype`` (default ``store_dtype``) stores ``V`` and ``W``, the
    arrays of the serial sweeps, apart from ``Sinv`` (bf16 ``Sinv`` with
    e4m3 ``V``/``W`` halves the sweeps' bytes again at bf16-grade solve
    quality).  An fp8 cast clamps to the format's finite range first
    (:func:`store_cast`).  Matvecs of stored factors cast the vector to
    the factor's dtype (bf16 for fp8 factors), accumulate in f32 and cast
    back (``ops.factor_matvec``).  The ~1e-2 relative factor error of bf16
    is within what the chord Newton tolerates from stale factors.  The
    serial loop is :func:`thomas_factor`.  ``blocks`` (B, nblk, nb, b, b),
    a batch of variants' Jacobians, gives a batch of factors (each field
    with the leading axis B).
    """
    check_dtypes(store_dtype, factor_dtype, offdiag_dtype)
    D, L, U, d = btd_superblocks(plan, factor_blocks(blocks, factor_dtype))
    Sinv, V, W = thomas_factor(D, L, U, "btd_factor")
    od = offdiag_dtype if offdiag_dtype is not None else store_dtype
    return BTDFactors(Sinv=store_cast(Sinv, store_dtype), V=store_cast(V, od),
                      W=store_cast(W, od), d=d)


def _padded(factors: BTDFactors, r: torch.Tensor):
    """``r / d`` padded to the row blocks, (..., n_sup, Bt)."""
    n_sup, Bt = factors.Sinv.shape[-3], factors.Sinv.shape[-1]
    n = r.shape[-1]
    rb = torch.nn.functional.pad(r / factors.d[..., :n], (0, n_sup * Bt - n))
    return rb.unflatten(-1, (n_sup, Bt))


def btd_solve(plan: BSBPlan, factors: BTDFactors,
              r: torch.Tensor) -> torch.Tensor:
    """Direct solve ``A x = r`` with the stored product-form factors:
    ``g = Sinv r`` as one batched product, then the two sweeps

        y_i = g_i - V_i y_{i-1}           (forward,  V = Sinv L)
        x_i = y_i - W_i x_{i+1}           (backward, W = Sinv U)

    each one launch of K6 on CUDA tensors (``ops.btd_sweep``).  Batched
    factors (a leading axis B) solve ``r`` (B, n): the sweeps are one
    launch each over the B chains."""
    Sinv, V, W, d = factors
    n = r.shape[-1]
    g = ops.factor_matvec(Sinv, _padded(factors, r))
    y = ops.btd_sweep(V, g)
    x = ops.btd_sweep(W, y, reverse=True)
    return x.flatten(-2)[..., :n] / d[..., :n]


def btd_solve_t(plan: BSBPlan, factors: BTDFactors,
                r: torch.Tensor) -> torch.Tensor:
    """Direct transposed solve ``A^T x = r`` with the stored factors
    (``vf_fem_tpu.solvers.btd.btd_solve_t``).  With ``A_s = Lt Ut``,
    ``A_s^T = Ut^T Lt^T``: the forward sweep ``z_i = r_i - W_{i-1}^T
    z_{i-1}``, the backward sweep ``w_i = z_i - V_{i+1}^T w_{i+1}``, each
    one launch of K6T on CUDA tensors (``ops.btd_sweep_t``, which shifts
    and transposes the blocks itself; over the chains of batched factors),
    then ``x = Sinv^T w`` as one batched product under
    :func:`~vf_fem_tpu_torch.ops.factor_matvec`'s rounding rule.  The
    equilibration is symmetric, so the scaling is :func:`btd_solve`'s."""
    Sinv, V, W, d = factors
    n = r.shape[-1]
    z = ops.btd_sweep_t(W, _padded(factors, r))
    w = ops.btd_sweep_t(V, z, reverse=True)
    x = ops.factor_matvec(Sinv.mT, w)
    return x.flatten(-2)[..., :n] / d[..., :n]
