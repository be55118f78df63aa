"""
Complex block-tridiagonal direct solver by the 2x real embedding
(counterpart of ``vf_fem_tpu.solvers.cbtd``).

Shift-invert eigenanalysis (``misc.hopf``) needs direct solves with the
complex-shifted pencil ``K + sigma D + sigma^2 M``.  Each complex
super-block ``Z = R + iI`` embeds as the real ``2Bt x 2Bt`` block
``[[R, -I], [I, R]]`` and a complex vector as its stacked ``[re; im]``
halves: the embedded system is again block tridiagonal with the same
super-block structure, so the block-Thomas loop of ``solvers.btd``
(:func:`~.btd.thomas_factor`) factors it at ``2Bt``, and each solve is two
sweeps of the block-Thomas kernel K6 at that width (``ops.btd_sweep``),
which is built for real factors only.  Equilibration uses the complex
modulus of the diagonal (a real diagonal scaling, valid for the embedded
system).

K6 is built for the row blocks ``ops.kernels.SWEEP_WIDTHS``; a plan whose
``2 h b`` is not one of them raises (for blocks of 128, any band but
``h = 1, 2, 5``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import ops
from ..ops.kernels import SWEEP_WIDTHS
from .bsb import BSBPlan
from .btd import _btd_from_bsb, _scale_blocks, thomas_factor

__all__ = ["CBTDFactors", "cbtd_factor", "cbtd_solve"]


class CBTDFactors(NamedTuple):
    """Product-form embedded Thomas factors (``V = Sinv L``, ``W = Sinv
    U``, as ``btd.BTDFactors``)."""

    Sinv: torch.Tensor  # (n_sup, 2Bt, 2Bt) embedded Schur inverses
    V: torch.Tensor  # (n_sup, 2Bt, 2Bt) products Sinv L
    W: torch.Tensor  # (n_sup, 2Bt, 2Bt) products Sinv U
    d: torch.Tensor  # (nblk * b,) real equilibration scale
    Bt: int


def _embed(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(n, Bt, Bt) real and imaginary parts -> (n, 2Bt, 2Bt) embedding."""
    top = torch.cat([re, -im], dim=2)
    bot = torch.cat([im, re], dim=2)
    return torch.cat([top, bot], dim=1)


def cbtd_factor(plan: BSBPlan, blocks_re: torch.Tensor,
                blocks_im: torch.Tensor) -> CBTDFactors:
    """Equilibrate and block-Thomas factor the complex banded matrix given
    as its (real, imaginary) band-block arrays, in their dtype."""
    b, h, nblk = plan.b, plan.h, plan.nblk
    if 2 * h * b not in SWEEP_WIDTHS:
        raise ValueError(
            f"cbtd_factor: the embedded row block 2*h*b = {2 * h * b} (h {h},"
            f" b {b}) is not a width the block-Thomas sweep kernel is built"
            f" for {SWEEP_WIDTHS}")
    # modulus equilibration (a real diagonal scaling of the complex system)
    diag_re = torch.diagonal(blocks_re[:, h], dim1=1, dim2=2)
    diag_im = torch.diagonal(blocks_im[:, h], dim1=1, dim2=2)
    d = torch.sqrt(torch.sqrt(diag_re**2 + diag_im**2) + 1e-30).reshape(-1)
    re_s = _scale_blocks(plan, blocks_re, d)
    im_s = _scale_blocks(plan, blocks_im, d)
    # the zero trailing pad rows of the last block get identity (real part)
    tail_start = plan.ndof - (nblk - 1) * b
    if tail_start < b:
        ii = torch.arange(tail_start, b, device=blocks_re.device)
        re_s[nblk - 1, h, ii, ii] += 1.0
    # _btd_from_bsb installs identity pad rows in both parts, so a pad
    # super-block embeds as [[I, -I], [I, I]]: nonsingular, and the pad
    # rhs is zero, so pad solutions never couple back into real dofs
    Dr, Lr, Ur = _btd_from_bsb(plan, re_s)
    Di, Li, Ui = _btd_from_bsb(plan, im_s)
    Sinv, V, W = thomas_factor(_embed(Dr, Di), _embed(Lr, Li), _embed(Ur, Ui),
                               "cbtd_factor")
    return CBTDFactors(Sinv=Sinv, V=V, W=W, d=d, Bt=h * b)


def cbtd_solve(plan: BSBPlan, factors: CBTDFactors, r_re: torch.Tensor,
               r_im: torch.Tensor):
    """Solve the complex system for the rhs ``r_re + i r_im``; returns
    ``(x_re, x_im)``.  ``g = Sinv r`` as one batched product, then the two
    sweeps ``y_i = g_i - V_i y_{i-1}`` and ``x_i = y_i - W_i x_{i+1}`` of
    the embedded system, each one launch of K6 at ``2Bt`` on CUDA tensors
    (``ops.btd_sweep``)."""
    Sinv, V, W, d, Bt = factors
    n_sup = Sinv.shape[0]
    n = r_re.shape[0]
    npad = n_sup * Bt - n

    def pack(v):
        return torch.nn.functional.pad(v / d[:n], (0, npad)).reshape(n_sup, Bt)

    rb = torch.cat([pack(r_re), pack(r_im)], dim=1)  # (n_sup, 2Bt)
    g = ops.factor_matvec(Sinv, rb)
    y = ops.btd_sweep(V, g)
    x = ops.btd_sweep(W, y, reverse=True)
    x_re = x[:, :Bt].reshape(-1)[:n] / d[:n]
    x_im = x[:, Bt:].reshape(-1)[:n] / d[:n]
    return x_re, x_im
