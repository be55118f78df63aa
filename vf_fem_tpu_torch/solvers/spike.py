"""
SPIKE-partitioned block-tridiagonal direct solver (counterpart of
``vf_fem_tpu.solvers.spike``).

The ``n_sup`` super-rows of the block-tridiagonal Jacobian (``solvers.btd``)
are split into ``S`` contiguous slabs of ``m`` super-rows (identity rows pad
``n_sup`` to ``S m``).  Each slab is block-Thomas factored on its own, all
slabs advancing together (batched over the slab axis); the couplings
between slabs become the "spikes" ``V_j = A_j^-1 (e_last C_j)`` and
``W_j = A_j^-1 (e_first B_j)``, and a reduced block-tridiagonal system of
``2S`` interface unknowns in ``2 Bt`` blocks ties the slabs together.

A solve is ``g = Sinv r`` (one batched product), the two local sweeps over
every slab (``y_i = g_i - P_i y_{i-1}``, ``x_i = y_i - Q_i x_{i+1}``: one
launch each of K6 over slabs on CUDA tensors, ``ops.btd_sweep`` with
(S, m, Bt, Bt) factors), the reduced solve for the interface values, and
the spike correction ``x_j = g_j - V_j x_{j+1}^t - W_j x_{j-1}^b``.

A batch of variants (``parallel.sweep``) carries a leading batch axis B
on every field of the factors and on the vectors: the slabs of all the
variants advance together in each serial loop, each local sweep is one
launch of K6 (K6T) over the B S slabs, and the reduced systems of every
variant are factored and solved in batched products.

Precision follows ``ops.factor_matvec``: stored bf16 or fp8 factors take
the vector cast to bf16, sum in f32 and return the vector's dtype.  The
spikes are computed before the cast, in the blocks' dtype (f32 with
``factor_dtype='float32'``), and the reduced factors stay in it.  The spikes' matrix sweeps and the reduced system's serial
Thomas loop are plain batched products (the JAX package's ``lax.scan``
einsums); the reduced solve reads nothing on the host, so a step that
solves with carried factors can be captured.

The transposed solve ``A^T x = r`` (the adjoint solves of value+grad, and
the DD step's backward) uses the same local factors with transposed sweeps,
``z_i = r_i - Q_{i-1}^T z_{i-1}``, ``w_i = z_i - P_{i+1}^T w_{i+1}``, ``x =
Sinv^T w`` (one launch each of K6T over slabs, ``ops.btd_sweep_t`` with
(S, m, Bt, Bt) factors), and its own spikes ``Vh``, ``Wh`` and reduced
system ``red_t``: ``A^T``'s slab couplings are ``B_{j+1}^T`` to the next
slab and ``C_{j-1}^T`` to the previous one.  Those are built only where a
run differentiates (``with_transpose``; the JAX package's flag, whose
default is on there and off here): a forward-only run's factors hold
``None`` in their place.

The storage and factor dtypes are ``btd_factor``'s (:func:`spike_factor`):
``store_dtype`` for ``Sinv``, ``offdiag_dtype`` (default ``store_dtype``)
for the arrays of the sweeps and the correction, ``P``, ``Q``, ``V``,
``W``, ``Vh``, ``Wh``, and ``factor_dtype``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import ops
from ..parallel.shards import shift_from_next, shift_from_prev
from .bsb import BSBPlan
from .btd import btd_superblocks, check_dtypes, factor_blocks, store_cast

__all__ = ["SPIKEFactors", "factor_slabs", "solve_slabs", "solve_slabs_t",
           "spike_factor", "spike_solve", "spike_solve_t", "spike_superblocks"]


class SPIKEFactors(NamedTuple):
    """Per-slab product-form Thomas factors, spikes and the reduced
    interface system's Thomas factors (leading axis ``S``, ``m`` super-rows
    a slab of ``Bt``), and those of the transposed system where they were
    built (``with_transpose``; else None).  Every other field is a tensor,
    so a step graph copies refreshed factors into its buffers field by
    field."""

    # each field may carry a leading batch axis (a batch of variants)
    Sinv: torch.Tensor  # (S, m, Bt, Bt) local Schur-complement inverses
    P: torch.Tensor  # (S, m, Bt, Bt) products Sinv L (P[:, 0] = 0)
    Q: torch.Tensor  # (S, m, Bt, Bt) products Sinv U (Q[:, -1] = 0)
    V: torch.Tensor  # (S, m, Bt, Bt) right spikes (V[S-1] = 0)
    W: torch.Tensor  # (S, m, Bt, Bt) left spikes (W[0] = 0)
    Sinv_r: torch.Tensor  # (S, 2Bt, 2Bt) reduced Schur-complement inverses
    L_r: torch.Tensor  # (S, 2Bt, 2Bt) reduced sub-diagonal blocks
    U_r: torch.Tensor  # (S, 2Bt, 2Bt) reduced super-diagonal blocks
    d: torch.Tensor  # (nblk * b,) Jacobi scale; (S, ndof_loc) of a DD step
    Vh: Optional[torch.Tensor] = None  # (S, m, Bt, Bt) spikes of A^T (Vh[S-1] = 0)
    Wh: Optional[torch.Tensor] = None  # (S, m, Bt, Bt) (Wh[0] = 0)
    Sinv_rt: Optional[torch.Tensor] = None  # (S, 2Bt, 2Bt) A^T's reduced factors
    L_rt: Optional[torch.Tensor] = None
    U_rt: Optional[torch.Tensor] = None

    @property
    def red(self):
        return self.Sinv_r, self.L_r, self.U_r

    @property
    def red_t(self):
        return self.Sinv_rt, self.L_rt, self.U_rt


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in the promoted dtype of the two (f32 reduced factors under
    f64 vectors: an f64 product, as the JAX package's matmul promotes)."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return (A.to(dt) @ x.to(dt).unsqueeze(-1)).squeeze(-1)


def split_slabs(D, L, U):
    """(..., S, m, Bt, Bt) slabs with the inter-slab couplings split off:
    ``B_j = L[j, 0]`` (to the previous slab) and ``C_j = U[j, m-1]`` (to
    the next), zeroed in L and U."""
    B = L[..., 0, :, :].clone()
    C = U[..., -1, :, :].clone()
    L = L.clone()
    U = U.clone()
    L[..., 0, :, :] = 0.0
    U[..., -1, :, :] = 0.0
    return D, L, U, B, C


def spike_superblocks(plan: BSBPlan, blocks: torch.Tensor, n_parts: int):
    """Slab-partitioned ``(D, L, U, B, C, d)`` of the banded Jacobian (a
    leading batch axis or none): the equilibrated super-blocks of
    ``btd_superblocks``, padded with identity rows to ``S m`` super-rows,
    as (..., S, m, Bt, Bt) slabs with the couplings ``B``, ``C`` (..., S,
    Bt, Bt) split off."""
    D, L, U, d = btd_superblocks(plan, blocks)
    lead = D.shape[:-3]
    n_sup, Bt = D.shape[-3], D.shape[-1]
    S = int(n_parts)
    m = -(-n_sup // S)
    pad = S * m - n_sup
    if pad:
        eye = torch.eye(Bt, dtype=D.dtype, device=D.device).expand(lead + (pad, Bt, Bt))
        D = torch.cat([D, eye], dim=-3)
        L = torch.cat([L, torch.zeros_like(eye)], dim=-3)
        U = torch.cat([U, torch.zeros_like(eye)], dim=-3)
    D, L, U = (x.reshape(lead + (S, m, Bt, Bt)) for x in (D, L, U))
    return (*split_slabs(D, L, U), d)


def local_factor(D, L, U):
    """Block-Thomas factors of every slab at once, ``(Sinv, P, Q)`` with
    ``P = Sinv L``, ``Q = Sinv U``: a serial loop of ``m`` batched
    ``solve_ex`` calls over the slabs (and the variants of a batch; their
    ``info`` read once, after the loop)."""
    m, Bt = D.shape[-3], D.shape[-1]
    eye = torch.eye(Bt, dtype=D.dtype, device=D.device).expand(D.shape[:-3] + (Bt, Bt))
    Sinv = torch.empty_like(D)
    Q = torch.empty_like(D)
    infos = []
    for i in range(m):
        if i == 0:
            Sm = D[..., 0, :, :]
        else:
            # Q_{i-1} = Sinv_{i-1} U_{i-1} falls out of the recurrence
            Q[..., i - 1, :, :] = Sinv[..., i - 1, :, :] @ U[..., i - 1, :, :]
            Sm = D[..., i, :, :] - L[..., i, :, :] @ Q[..., i - 1, :, :]
        Sinv[..., i, :, :], info = torch.linalg.solve_ex(Sm, eye)
        infos.append(info)
    Q[..., -1, :, :] = Sinv[..., -1, :, :] @ U[..., -1, :, :]
    bad = torch.nonzero(torch.stack(infos, dim=-1))
    if bad.numel():
        raise RuntimeError("spike_factor: singular Schur complement at (slab,"
                           f" super-row) {bad.tolist()}")
    return Sinv, Sinv @ L, Q


def _local_solve_mat(Sinv, P, Q, R):
    """The product-form Thomas solve of every slab for matrix right-hand
    sides R (..., S, m, Bt, k): the spikes, in the factors' dtype."""
    g = Sinv @ R
    m = R.shape[-3]
    y = torch.empty_like(g)
    y[..., 0, :, :] = g[..., 0, :, :]
    for i in range(1, m):
        y[..., i, :, :] = g[..., i, :, :] - P[..., i, :, :] @ y[..., i - 1, :, :]
    x = torch.empty_like(g)
    x[..., -1, :, :] = y[..., -1, :, :]
    for i in range(m - 2, -1, -1):
        x[..., i, :, :] = y[..., i, :, :] - Q[..., i, :, :] @ x[..., i + 1, :, :]
    return x


def _local_solve_t_mat(Sinv, P, Q, R):
    """The transposed product-form solve of every slab for matrix
    right-hand sides R (..., S, m, Bt, k): ``z_i = R_i - Q_{i-1}^T
    z_{i-1}``, ``w_i = z_i - P_{i+1}^T w_{i+1}``, ``Sinv^T w`` (the
    transposed spikes, in the factors' dtype)."""
    m = R.shape[-3]
    z = torch.empty_like(R)
    z[..., 0, :, :] = R[..., 0, :, :]
    for i in range(1, m):
        z[..., i, :, :] = R[..., i, :, :] - Q[..., i - 1, :, :].mT @ z[..., i - 1, :, :]
    w = torch.empty_like(z)
    w[..., -1, :, :] = z[..., -1, :, :]
    for i in range(m - 2, -1, -1):
        w[..., i, :, :] = z[..., i, :, :] - P[..., i + 1, :, :].mT @ w[..., i + 1, :, :]
    return Sinv.mT @ w


def local_solve(Sinv, P, Q, R):
    """The product-form Thomas solve of every slab for vector right-hand
    sides R (..., S, m, Bt): ``g = Sinv R`` (``ops.factor_matvec``), then
    the forward sweep on P and the backward sweep on Q, one launch of K6
    over every slab (of every variant) each (``ops.btd_sweep``)."""
    g = ops.factor_matvec(Sinv, R)
    y = ops.btd_sweep(P, g)
    return ops.btd_sweep(Q, y, reverse=True)


def local_solve_t(Sinv, P, Q, R):
    """The transposed solve of every slab for vector right-hand sides R
    (..., S, m, Bt): the forward sweep on Q and the backward sweep on P,
    each transposed and shifted by one block, one launch of K6T over every
    slab each (``ops.btd_sweep_t``), then ``Sinv^T w``
    (``ops.factor_matvec``)."""
    z = ops.btd_sweep_t(Q, R)
    w = ops.btd_sweep_t(P, z, reverse=True)
    return ops.factor_matvec(Sinv.mT, w)


def spikes_t(Sinv, P, Q, B, C):
    """The spikes of ``A^T``: ``Vh = A_j^-T (e_last B_{j+1}^T)``, ``Wh =
    A_j^-T (e_0 C_{j-1}^T)``, the neighbours' coupling blocks by shifts
    along the slab axis (zero past the ends)."""
    R_V = torch.zeros_like(Sinv)
    R_V[..., -1, :, :] = shift_from_next(B, dim=-3).mT
    R_W = torch.zeros_like(Sinv)
    R_W[..., 0, :, :] = shift_from_prev(C, dim=-3).mT
    return _local_solve_t_mat(Sinv, P, Q, R_V), _local_solve_t_mat(Sinv, P, Q, R_W)


def spikes(Sinv, P, Q, B, C):
    """The right and left spikes ``V = A_j^-1 (e_last C_j)``, ``W =
    A_j^-1 (e_0 B_j)`` from the local factors (forward solves only)."""
    R_V = torch.zeros_like(Sinv)
    R_V[..., -1, :, :] = C
    R_W = torch.zeros_like(Sinv)
    R_W[..., 0, :, :] = B
    return _local_solve_mat(Sinv, P, Q, R_V), _local_solve_mat(Sinv, P, Q, R_W)


def reduced_blocks(V_tips, W_tips):
    """The reduced interface system from the spike tips (rows 0 and m-1 of
    each slab's spikes, ``(..., S, k, Bt, Bt)``, k >= 1): row j reads ``z_j
    + L_r[j] z_{j-1} + U_r[j] z_{j+1} = g_j`` with ``z_j = (x_j^t,
    x_j^b)``.  Returns ``(D_r, L_r, U_r)``, (..., S, 2Bt, 2Bt) each."""
    Bt = V_tips.shape[-1]
    Z = torch.zeros_like(V_tips[..., 0, :, :])

    def blk(tl, tr, bl, br):
        return torch.cat([torch.cat([tl, tr], -1), torch.cat([bl, br], -1)], -2)

    L_r = blk(Z, W_tips[..., 0, :, :], Z, W_tips[..., -1, :, :])
    U_r = blk(V_tips[..., 0, :, :], Z, V_tips[..., -1, :, :], Z)
    D_r = torch.eye(2 * Bt, dtype=V_tips.dtype, device=V_tips.device).expand(L_r.shape)
    return D_r, L_r, U_r


def seq_thomas_factor(D, L, U):
    """Serial block-Thomas factorization of the (tiny) reduced system
    (..., n, 2Bt, 2Bt), each row one batched solve over the variants of a
    batch: the Schur-complement inverses ``Sinv_i = (D_i - L_i Sinv_{i-1}
    U_{i-1})^-1``."""
    n, Bt = D.shape[-3], D.shape[-1]
    eye = torch.eye(Bt, dtype=D.dtype, device=D.device).expand(D.shape[:-3] + (Bt, Bt))
    Sinv = torch.empty_like(D)
    infos = []
    for i in range(n):
        # contiguous: D_r is an expanded identity, whose batch of one
        # stride-0 matrix the CPU's LU refuses
        Sm = (D[..., 0, :, :].contiguous() if i == 0 else
              D[..., i, :, :] - L[..., i, :, :] @ (Sinv[..., i - 1, :, :] @ U[..., i - 1, :, :]))
        Sinv[..., i, :, :], info = torch.linalg.solve_ex(Sm, eye)
        infos.append(info)
    if torch.stack(infos).any():
        raise RuntimeError("spike_factor: singular reduced interface system")
    return Sinv


def seq_thomas_solve(Sinv, L, U, r):
    """Solve the reduced system (..., n, 2Bt) with its factors: a loop of
    small (batched) matvecs on the device, no host read."""
    n = r.shape[-2]
    y = torch.empty_like(r)
    y[..., 0, :] = _mv(Sinv[..., 0, :, :], r[..., 0, :])
    for i in range(1, n):
        y[..., i, :] = _mv(Sinv[..., i, :, :], r[..., i, :] - _mv(L[..., i, :, :], y[..., i - 1, :]))
    x = torch.empty_like(r)
    x[..., -1, :] = y[..., -1, :]
    for i in range(n - 2, -1, -1):
        x[..., i, :] = y[..., i, :] - _mv(Sinv[..., i, :, :], _mv(U[..., i, :, :], x[..., i + 1, :]))
    return x


def reduced_factor(V_tips, W_tips):
    """``(Sinv_r, L_r, U_r)`` of the reduced system of the spike tips."""
    D_r, L_r, U_r = reduced_blocks(V_tips, W_tips)
    return seq_thomas_factor(D_r, L_r, U_r), L_r, U_r


def store(factors: SPIKEFactors, store_dtype, offdiag_dtype=None) -> SPIKEFactors:
    """``Sinv`` of ``factors`` cast to ``store_dtype`` and ``P``, ``Q``,
    ``V``, ``W`` (and ``Vh``, ``Wh`` where built) to ``offdiag_dtype``
    (default ``store_dtype``), by the JAX package's names, fp8 clamped to
    its finite range (``solvers.btd.store_cast``); the reduced factors keep
    full precision.  Raises ``ValueError`` naming the supported dtypes."""
    check_dtypes(store_dtype=store_dtype, offdiag_dtype=offdiag_dtype)
    od = offdiag_dtype if offdiag_dtype is not None else store_dtype
    if store_dtype is None and od is None:
        return factors
    return factors._replace(
        Sinv=store_cast(factors.Sinv, store_dtype),
        **{k: store_cast(getattr(factors, k), od)
           for k in ("P", "Q", "V", "W", "Vh", "Wh") if getattr(factors, k) is not None})


def spike_factor(plan: BSBPlan, blocks: torch.Tensor, n_parts: int = 8,
                 store_dtype=None, with_transpose: bool = False,
                 factor_dtype=None, offdiag_dtype=None) -> SPIKEFactors:
    """Factor the banded Jacobian with ``n_parts`` SPIKE slabs, in the
    blocks' dtype or ``factor_dtype`` ('float32', cast before factoring);
    ``store_dtype`` and ``offdiag_dtype`` store the large factor arrays
    below it (:func:`store`, as ``btd_factor``); ``with_transpose`` also
    builds the transposed system's spikes and reduced factors, which
    :func:`spike_solve_t` needs."""
    check_dtypes(store_dtype, factor_dtype, offdiag_dtype)
    blocks = factor_blocks(blocks, factor_dtype)
    return store(factor_slabs(*spike_superblocks(plan, blocks, n_parts),
                              with_transpose=with_transpose), store_dtype, offdiag_dtype)


def factor_slabs(D, L, U, B, C, d, with_transpose: bool = False) -> SPIKEFactors:
    """SPIKE factors of equilibrated slabs ``D, L, U`` (S, m, Bt, Bt) with
    their couplings ``B, C`` (S, Bt, Bt) split off (:func:`split_slabs`) and
    the scale ``d`` they were equilibrated with: the local Thomas factors,
    the spikes and the reduced system of the spike tips, and with
    ``with_transpose`` those of ``A^T`` (:func:`spikes_t`)."""
    Sinv, P, Q = local_factor(D, L, U)
    V, W = spikes(Sinv, P, Q, B, C)
    fac = SPIKEFactors(Sinv, P, Q, V, W, *reduced_factor(V, W), d)
    if not with_transpose:
        return fac
    Vh, Wh = spikes_t(Sinv, P, Q, B, C)
    Sinv_rt, L_rt, U_rt = reduced_factor(Vh, Wh)
    return fac._replace(Vh=Vh, Wh=Wh, Sinv_rt=Sinv_rt, L_rt=L_rt, U_rt=U_rt)


def interface_values(z: torch.Tensor, Bt: int):
    """From the reduced solution z (..., S, 2Bt): each slab's next slab's
    top ``x_{j+1}^t`` and previous slab's bottom ``x_{j-1}^b`` (zero past
    the ends)."""
    xt, xb = z[..., :Bt], z[..., Bt:]
    zero = torch.zeros_like(xt[..., :1, :])  # one zero block for both: a node less a solve
    return torch.cat([xt[..., 1:, :], zero], -2), torch.cat([zero, xb[..., :-1, :]], -2)


def spike_correct(g, V, W, xt_next, xb_prev):
    """``g - V x_{j+1}^t - W x_{j-1}^b`` slab by slab, under
    ``ops.factor_matvec``'s rounding rule."""
    return (g - ops.factor_matvec(V, xt_next[..., None, :]) -
            ops.factor_matvec(W, xb_prev[..., None, :]))


def interface_correct(g, red, V, W):
    """The reduced interface solve (factors ``red``) and the spike
    correction (spikes ``V``, ``W``) of the local solutions ``g`` (S, m,
    Bt): ``A``'s or, with the transposed parts, ``A^T``'s."""
    rhs = torch.cat([g[..., 0, :], g[..., -1, :]], dim=-1)  # (..., S, 2Bt)
    z = seq_thomas_solve(*red, rhs)
    return spike_correct(g, V, W, *interface_values(z, g.shape[-1]))


def _solve_vec(factors: SPIKEFactors, r: torch.Tensor, solve) -> torch.Tensor:
    """``solve`` of the equilibrated slab system for ``r`` (..., n), scaled
    in and out by ``d``."""
    S, m, Bt, _ = factors.Sinv.shape[-4:]
    d = factors.d
    n = r.shape[-1]
    rb = torch.nn.functional.pad(r / d[..., :n], (0, S * m * Bt - n)).unflatten(-1, (S, m, Bt))
    return solve(factors, rb).flatten(-3)[..., :n] / d[..., :n]


def spike_solve(plan: BSBPlan, factors: SPIKEFactors,
                r: torch.Tensor) -> torch.Tensor:
    """Direct solve ``A x = r`` with the SPIKE factors."""
    return _solve_vec(factors, r, solve_slabs)


def solve_slabs(factors: SPIKEFactors, rb: torch.Tensor) -> torch.Tensor:
    """Solve the equilibrated slab system for right-hand sides ``rb`` (S,
    m, Bt): the local solves, then the interface correction."""
    g = local_solve(factors.Sinv, factors.P, factors.Q, rb)
    return interface_correct(g, factors.red, factors.V, factors.W)


def solve_slabs_t(factors: SPIKEFactors, rb: torch.Tensor) -> torch.Tensor:
    """:func:`solve_slabs` of the transposed system: the transposed local
    solves, then the interface correction with ``A^T``'s spikes and reduced
    factors (which ``factors`` must hold: ``with_transpose``)."""
    if factors.Vh is None:
        raise ValueError("spike_solve_t: the factors were built without the"
                         " transposed parts (spike_factor(..., with_transpose=True))")
    g = local_solve_t(factors.Sinv, factors.P, factors.Q, rb)
    return interface_correct(g, factors.red_t, factors.Vh, factors.Wh)


def spike_solve_t(plan: BSBPlan, factors: SPIKEFactors,
                  r: torch.Tensor) -> torch.Tensor:
    """Direct transposed solve ``A^T x = r`` with the same factors."""
    return _solve_vec(factors, r, solve_slabs_t)
