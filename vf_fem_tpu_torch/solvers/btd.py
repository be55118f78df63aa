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

Requires an RCM-renumbered mesh like ``bsb``; used through
``linear_solver='btd'``.  Not ported: the fp8 ``offdiag_dtype`` storage
and the ``factor_dtype`` cast (the TPU's workaround for its missing f64
LU).
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
STORE_DTYPES = {"bfloat16": torch.bfloat16}


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

    Sinv: torch.Tensor  # (n_sup, Bt, Bt) Schur-complement inverses
    V: torch.Tensor  # (n_sup, Bt, Bt) products Sinv_i @ L_i
    W: torch.Tensor  # (n_sup, Bt, Bt) products Sinv_i @ U_i
    d: torch.Tensor  # (nblk * b,) Jacobi equilibration scale


def _btd_from_bsb(plan: BSBPlan, blocks: torch.Tensor):
    """Regroup band blocks into block-tridiagonal (D, L, U) super-blocks;
    identity rows pad the last super-row when ``n_sup * h > nblk``."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    dev = blocks.device
    n_sup = -(-nblk // h)
    pad = n_sup * h - nblk
    if pad:
        # identity padding rows keep the factorization nonsingular
        eye_rows = blocks.new_zeros((pad, nb, b, b))
        eye_rows[:, h] = torch.eye(b, dtype=blocks.dtype, device=dev)
        blocks = torch.cat([blocks, eye_rows])

    rr, cc = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    n_idx = torch.as_tensor(h * np.arange(n_sup)[:, None, None] + rr[None],
                            device=dev)

    def gather(m_grid, mask):
        m = torch.as_tensor(np.clip(m_grid, 0, nb - 1), device=dev)
        sub = blocks[n_idx, m[None]]  # (n_sup, h, h, b, b)
        sub = sub * torch.as_tensor(mask, dtype=blocks.dtype,
                                    device=dev)[None, :, :, None, None]
        # (n_sup, h, h, b, b) -> (n_sup, h*b, h*b)
        return sub.permute(0, 1, 3, 2, 4).reshape(n_sup, h * b, h * b)

    ones = np.ones((h, h), dtype=bool)
    D = gather(h + cc - rr, ones)
    U = gather(2 * h + cc - rr, cc <= rr)
    L = gather(cc - rr, cc >= rr)
    return D, L, U


def _equilibration(plan: BSBPlan, blocks: torch.Tensor) -> torch.Tensor:
    diag = torch.diagonal(blocks[:, plan.h], dim1=1, dim2=2)  # (nblk, b)
    return torch.sqrt(torch.abs(diag) + 1e-30).reshape(-1)


def _scale_blocks(plan: BSBPlan, blocks: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """blocks <- D^-1/2 A D^-1/2 in band storage."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    dr = d.reshape(nblk, b)
    # column scale for band position m: block column n + m - h (clamped;
    # the out-of-range positions hold zero blocks, so the value is moot)
    col_idx = np.clip(
        np.arange(nblk)[:, None] + np.arange(nb)[None, :] - h, 0, nblk - 1
    )
    dc = dr[torch.as_tensor(col_idx, device=d.device)]  # (nblk, nb, b)
    return blocks / dr[:, None, :, None] / dc[:, :, None, :]


def btd_superblocks(plan: BSBPlan, blocks: torch.Tensor):
    """Equilibrate the banded Jacobian and regroup it into
    block-tridiagonal super-blocks: ``(D, L, U, d)``."""
    d = _equilibration(plan, blocks)
    blocks_s = _scale_blocks(plan, blocks, d)
    # the trailing pad rows of the last block (beyond ndof) are all-zero;
    # a direct factorization needs identity rows there (in the scaled
    # space)
    tail_start = plan.ndof - (plan.nblk - 1) * plan.b
    if tail_start < plan.b:
        ii = torch.arange(tail_start, plan.b, device=blocks.device)
        blocks_s[plan.nblk - 1, plan.h, ii, ii] += 1.0
    D, L, U = _btd_from_bsb(plan, blocks_s)
    return D, L, U, d


def btd_factor(plan: BSBPlan, blocks: torch.Tensor,
               store_dtype=None) -> BTDFactors:
    """Equilibrate and block-Thomas factor the banded Jacobian, in the
    blocks' dtype.

    ``store_dtype='bfloat16'`` stores ``Sinv``, ``V`` and ``W`` half-width
    (the solve streams them); their matvecs cast the vector to bf16 and
    accumulate in f32 (``ops.factor_matvec``).  The ~1e-2 relative factor
    error is within what the chord Newton tolerates from stale factors.

    The ``n_sup`` inverses are ``torch.linalg.solve_ex`` calls, whose
    ``info`` is read once after the loop (raises if a Schur complement is
    singular), not once per row.
    """
    if store_dtype is not None and store_dtype not in STORE_DTYPES:
        raise ValueError(f"btd_factor: store_dtype {store_dtype!r} is not"
                         f" supported ({tuple(STORE_DTYPES)})")
    D, L, U, d = btd_superblocks(plan, blocks)
    n_sup, Bt, _ = D.shape
    eye = torch.eye(Bt, dtype=D.dtype, device=D.device)
    Sinv = torch.empty_like(D)
    W = torch.empty_like(D)
    infos = []
    for i in range(n_sup):
        if i == 0:
            S = D[0]
        else:
            # SU = Sinv_{i-1} @ U_{i-1} is W_{i-1}: the W products fall
            # out of the factorization
            W[i - 1] = Sinv[i - 1] @ U[i - 1]
            S = D[i] - L[i] @ W[i - 1]
        Sinv[i], info = torch.linalg.solve_ex(S, eye)
        infos.append(info)
    W[-1] = Sinv[-1] @ U[-1]
    bad = torch.nonzero(torch.stack(infos)).flatten()
    if bad.numel():
        raise RuntimeError(f"btd_factor: singular Schur complement at"
                           f" super-rows {bad.tolist()}")
    # V = Sinv @ L as one batched matmul, outside the serial loop
    V = torch.bmm(Sinv, L)
    if store_dtype is not None:
        dt = STORE_DTYPES[store_dtype]
        Sinv, V, W = Sinv.to(dt), V.to(dt), W.to(dt)
    return BTDFactors(Sinv=Sinv, V=V, W=W, d=d)


def btd_solve(plan: BSBPlan, factors: BTDFactors,
              r: torch.Tensor) -> torch.Tensor:
    """Direct solve ``A x = r`` with the stored product-form factors:
    ``g = Sinv r`` as one batched product, then the two sweeps

        y_i = g_i - V_i y_{i-1}           (forward,  V = Sinv L)
        x_i = y_i - W_i x_{i+1}           (backward, W = Sinv U)

    each one launch of K6 on CUDA tensors (``ops.btd_sweep``)."""
    Sinv, V, W, d = factors
    n_sup, Bt, _ = Sinv.shape
    n = r.shape[0]
    rb = torch.nn.functional.pad(r / d[:n], (0, n_sup * Bt - n))
    g = ops.factor_matvec(Sinv, rb.reshape(n_sup, Bt))
    y = ops.btd_sweep(V, g)
    x = ops.btd_sweep(W, y, reverse=True)
    return x.reshape(-1)[:n] / d[:n]


def btd_solve_t(plan: BSBPlan, factors: BTDFactors,
                r: torch.Tensor) -> torch.Tensor:
    """Direct transposed solve ``A^T x = r`` with the stored factors
    (``vf_fem_tpu.solvers.btd.btd_solve_t``).  With ``A_s = Lt Ut``,
    ``A_s^T = Ut^T Lt^T``: the forward sweep ``z_i = r_i - W_{i-1}^T
    z_{i-1}``, the backward sweep ``w_i = z_i - V_{i+1}^T w_{i+1}``, each
    one launch of K6T on CUDA tensors (``ops.btd_sweep_t``, which shifts
    and transposes the blocks itself), then ``x = Sinv^T w`` as one batched
    product under :func:`~vf_fem_tpu_torch.ops.factor_matvec`'s rounding
    rule.  The equilibration is symmetric, so the scaling is
    :func:`btd_solve`'s."""
    Sinv, V, W, d = factors
    n_sup, Bt, _ = Sinv.shape
    n = r.shape[0]
    rb = torch.nn.functional.pad(r / d[:n], (0, n_sup * Bt - n))
    z = ops.btd_sweep_t(W, rb.reshape(n_sup, Bt))
    w = ops.btd_sweep_t(V, z, reverse=True)
    x = ops.factor_matvec(Sinv.mT, w)
    return x.reshape(-1)[:n] / d[:n]
