"""
The solver kernels: K3 (element-by-element matvec), K4 (block-banded
matvec), K5 (fused Newmark update) and K6 (block-Thomas sweep), and the
kernels of the gradient path: K5T (K5's backward, under the
``autograd.Function`` :func:`newmark_step`, whose tangent is two K5
launches), K6T (the transposed sweep of ``solvers.btd.btd_solve_t``), and
K3T and K4T (the transposed operators of the 'cg' and 'bsb' adjoint
solves: :func:`ebe_matvec_t`, :func:`bsb_matvec_t`).

Counterparts of ``vf_fem_tpu/ops/pallas_kernels.py``: ``ebe_matvec``
replaces ``_ebe_matvec_kernel``, ``bsb_matvec`` replaces
``_bsb_matvec_kernel``, ``newmark_update`` replaces ``_newmark_kernel``.
``btd_sweep`` has no TPU kernel: it runs the serial sweeps of
``solvers.btd.btd_solve``, a ``lax.scan`` in the JAX package; neither has
``btd_sweep_t`` (the ``lax.scan`` of ``btd_solve_t``) nor
``newmark_update_t`` (the JAX package differentiates the Newmark relations
with its step), nor ``ebe_matvec_t`` and ``bsb_matvec_t`` (XLA in the JAX
package: ``EBEOperator.matvec_transpose``, ``solvers.bsb.bsb_matvec_t``).
The CUDA
sources are ``csrc/ops.cu`` and ``csrc/btd.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, see ``cuda_build``).

Each wrapper dispatches on its tensors' device: on CUDA tensors it launches
the kernel (or raises), on CPU tensors it runs the plain PyTorch version
(``*_reference``).  ``LAUNCHES`` counts kernel launches, where each kernel
is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from .. import cuda_build
from ..equations import newmark

__all__ = [
    "LAUNCHES",
    "ebe_matvec",
    "ebe_matvec_reference",
    "ebe_matvec_t",
    "ebe_matvec_t_reference",
    "bsb_matvec",
    "bsb_matvec_reference",
    "bsb_matvec_t",
    "bsb_matvec_t_reference",
    "newmark_update",
    "newmark_update_coefs",
    "newmark_update_coefs_reference",
    "newmark_update_reference",
    "newmark_row",
    "newmark_step",
    "newmark_update_t",
    "newmark_update_t_reference",
    "newmark_update_t_batch",
    "newmark_update_t_batch_reference",
    "factor_matvec",
    "btd_sweep",
    "btd_sweep_reference",
    "btd_sweep_rows_reference",
    "btd_sweep_slabs_reference",
    "btd_sweep_t",
    "btd_sweep_t_reference",
    "btd_sweep_t_rows_reference",
    "sweep_plan",
    "sweep_t_plan",
    "dot_order_bound",
]

LAUNCHES = {"ebe_matvec": 0, "bsb_matvec": 0, "newmark": 0, "btd_sweep": 0,
            "newmark_t": 0, "btd_sweep_t": 0, "ebe_matvec_t": 0, "bsb_matvec_t": 0,
            "btd_sweep_slabs": 0}

BSB_BLOCK = 128  # the block size K4 is compiled for
BSB_LANES = 4  # lanes a row of K4 and a column of K4T (csrc/ops.cu: kBsbLanes)
BSB_T_COLS = 64  # columns a K4T CTA (csrc/ops.cu: kBsbTile)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {}
for _t in ("f32", "f64"):
    for _op in ("", "_t"):
        _SIGNATURES[f"vf_ebe_matvec{_op}_{_t}"] = [_P, _P, _P, _P, _I, _I, _P]
        _SIGNATURES[f"vf_bsb_matvec{_op}_{_t}"] = [_P] * 5 + [_I] * 3 + [_P]
    _SIGNATURES[f"vf_newmark_{_t}"] = [_P] * 7 + [_L, _P, _P]
    _SIGNATURES[f"vf_newmark_t_{_t}"] = [_P] * 12 + [_I, _L, _P]
    _SIGNATURES[f"vf_newmark_t_batch_{_t}"] = [_P] * 12 + [_L, _L, _P]
_SIGNATURES["vf_capture_id"] = [_P, _P]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return cuda_build.load("ops.cu", _SIGNATURES)


def _launch(name: str, dtype, *args):
    fn = f"{name}_{_SUFFIX[dtype]}"
    err = getattr(_lib(), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")


def _stream(t: torch.Tensor) -> int:
    return cuda_build.raw_stream(t)


def _check(what: str, *tensors: torch.Tensor):
    """Same float dtype (f32/f64), same device (CPU or CUDA), contiguous."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if dtype not in _SUFFIX:
        raise TypeError(f"{what}: float32 or float64 expected, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{what}: mixed dtypes {dtype} and {t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: tensors on {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    if device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")


def dot_order_bound(abs_result: torch.Tensor, n: int,
                    acc_dtype=None) -> torch.Tensor:
    """Bound on the difference between two evaluation orders of the same
    dot products of length ``n``: each is within ``gamma_n sum|a_j x_j|`` of
    the exact value (``gamma_n = n u / (1 - n u)``, ``u`` the unit
    roundoff of the accumulation, ``acc_dtype``, by default
    ``abs_result``'s), so two of them within twice that.  ``abs_result``
    is the operation applied to ``|a|`` and ``|x|``."""
    u = torch.finfo(acc_dtype or abs_result.dtype).eps / 2
    return 2 * (n * u / (1 - n * u)) * abs_result


# -- K3: element-by-element matvec -------------------------------------------


def ebe_matvec_reference(J: torch.Tensor, x: torch.Tensor,
                         dofs: torch.Tensor) -> torch.Tensor:
    """``y[e] = J[e] @ x[dofs[e]]``: J (ne, nld, nld), x (ndof,), dofs
    (ne, nld) int64 -> (ne, nld)."""
    return torch.einsum("eij,ej->ei", J, x[dofs])


def ebe_matvec_t_reference(J: torch.Tensor, x: torch.Tensor,
                           dofs: torch.Tensor) -> torch.Tensor:
    """``y[e] = J[e]^T @ x[dofs[e]]``, shapes as
    :func:`ebe_matvec_reference`."""
    return torch.einsum("eji,ej->ei", J, x[dofs])


def _ebe(name: str, J: torch.Tensor, x: torch.Tensor, dofs: torch.Tensor,
         reference) -> torch.Tensor:
    """K3 or K3T (``name``) on CUDA, ``reference`` on the CPU."""
    _check(name, J, x)
    ne, nld, nld2 = J.shape
    if nld != nld2 or tuple(dofs.shape) != (ne, nld) or x.dim() != 1:
        raise ValueError(
            f"{name}: J {tuple(J.shape)}, x {tuple(x.shape)},"
            f" dofs {tuple(dofs.shape)}"
        )
    if dofs.dtype != torch.int64 or dofs.device != J.device:
        raise TypeError(f"{name}: dofs must be int64 on J's device")
    if J.device.type == "cpu":
        return reference(J, x, dofs)
    if not dofs.is_contiguous():
        raise ValueError(f"{name}: dofs must be contiguous")
    y = torch.empty((ne, nld), dtype=J.dtype, device=J.device)
    _launch(f"vf_{name}", J.dtype, J.data_ptr(), x.data_ptr(),
            dofs.data_ptr(), y.data_ptr(), ne, nld, _stream(J))
    LAUNCHES[name] += 1
    return y


def ebe_matvec(J: torch.Tensor, x: torch.Tensor,
               dofs: torch.Tensor) -> torch.Tensor:
    """Batched element matvec through the element dof map (K3 on CUDA)."""
    return _ebe("ebe_matvec", J, x, dofs, ebe_matvec_reference)


def ebe_matvec_t(J: torch.Tensor, x: torch.Tensor,
                 dofs: torch.Tensor) -> torch.Tensor:
    """Batched transposed element matvec ``J[e]^T @ x[dofs[e]]`` (K3T on
    CUDA): the element products of ``EBEOperator.matvec_transpose``."""
    return _ebe("ebe_matvec_t", J, x, dofs, ebe_matvec_t_reference)


# -- K4: block-banded matvec ---------------------------------------------------


def bsb_matvec_reference(plan, blocks: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """``y_n = sum_m blocks[n, m] @ xpad[(n+m)*b : (n+m+1)*b]`` with x
    zero-padded by h blocks in front and ``h*b + (nblk*b - ndof)`` behind:
    ``nb`` shifted contiguous windows and one batched product."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    pad_tail = nblk * b - plan.ndof
    xpad = torch.nn.functional.pad(x, (h * b, h * b + pad_tail))
    xw = torch.stack(
        [xpad[m * b : m * b + nblk * b].reshape(nblk, b) for m in range(nb)],
        dim=1,
    )
    y = torch.einsum("nmij,nmj->ni", blocks, xw)
    return y.reshape(-1)[: plan.ndof]


def bsb_matvec_t_reference(plan, blocks: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """``y = A^T x`` by the JAX package's algorithm
    (``vf_fem_tpu.solvers.bsb.bsb_matvec_t``): ``blocks[n, m]^T @ x_n``
    for every band position in one batched product, each added into block
    row ``n + m - h`` of a padded output."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    pad_tail = nblk * b - plan.ndof
    xpad = torch.nn.functional.pad(x, (0, pad_tail)).reshape(nblk, b)
    contrib = torch.einsum("nmij,ni->nmj", blocks, xpad)
    ypad = x.new_zeros((nblk + 2 * h) * b)
    for m in range(nb):
        ypad[m * b : m * b + nblk * b] += contrib[:, m].reshape(-1)
    return ypad[h * b : h * b + plan.ndof]


def _check_bsb(name: str, plan, blocks: torch.Tensor, x: torch.Tensor):
    _check(name, blocks, x)
    shape = (plan.nblk, plan.nb, plan.b, plan.b)
    if tuple(blocks.shape) != shape or tuple(x.shape) != (plan.ndof,):
        raise ValueError(
            f"{name}: blocks {tuple(blocks.shape)} (plan {shape}),"
            f" x {tuple(x.shape)} (ndof {plan.ndof})"
        )


def bsb_matvec(plan, blocks: torch.Tensor, x: torch.Tensor,
               pattern=None) -> torch.Tensor:
    """Block-banded matvec ``y = A x`` of ``solvers.bsb`` (K4 on CUDA).
    ``plan`` is a :class:`~vf_fem_tpu_torch.solvers.bsb.BSBPlan`;
    ``pattern`` its :class:`~vf_fem_tpu_torch.solvers.bsb.MatvecPattern`
    on the device (``fill_plan(plan, device).pattern``), outside which
    ``blocks`` must be zero (as ``bsb_fill`` leaves it).  K4 reads only the
    pattern's entries and raises without one; the plain version on the CPU
    reads the whole band and ignores it."""
    _check_bsb("bsb_matvec", plan, blocks, x)
    if x.device.type == "cpu":
        return bsb_matvec_reference(plan, blocks, x)
    return _bsb_launch(plan, blocks, x, pattern)


def bsb_matvec_t(plan, blocks: torch.Tensor, x: torch.Tensor,
                 pattern_t=None) -> torch.Tensor:
    """The transposed block-banded matvec ``y = A^T x`` (K4T on CUDA), the
    operator of the 'bsb' adjoint solve.  ``pattern_t`` is the plan's
    transposed pattern on the device (``fill_plan(plan, device).pattern_t``,
    ``solvers.bsb.matvec_pattern_t``: CSR by output column); K4T reads only
    its entries and raises without it; the plain version on the CPU reads
    the whole band and ignores it."""
    _check_bsb("bsb_matvec_t", plan, blocks, x)
    if x.device.type == "cpu":
        return bsb_matvec_t_reference(plan, blocks, x)
    return _bsb_launch(plan, blocks, x, pattern_t, "bsb_matvec_t")


def _bsb_launch(plan, blocks: torch.Tensor, x: torch.Tensor, pattern,
                name: str = "bsb_matvec") -> torch.Tensor:
    """Launch K4 or K4T (``name``) on CUDA tensors checked against
    ``plan``, with its pattern (by row for K4, by column for K4T)."""
    if pattern is None:
        which = "pattern" if name == "bsb_matvec" else "pattern_t"
        raise ValueError(f"{name}: the kernel needs the plan's {which}"
                         f" (solvers.bsb.fill_plan(plan, device).{which})")
    if plan.b != BSB_BLOCK:
        raise ValueError(f"{name}: kernel built for b={BSB_BLOCK}, plan"
                         f" has b={plan.b}")
    ptr, off = pattern
    for field, t, n in (("ptr", ptr, plan.ndof + 1), ("off", off, None)):
        if (t.dtype != torch.int32 or t.device != x.device or t.dim() != 1
                or not t.is_contiguous() or (n is not None and t.numel() != n)):
            raise ValueError(f"{name}: pattern.{field} must be a contiguous"
                             f" int32 vector on {x.device}"
                             + ("" if n is None else f" of {n} entries"))
    if x.data_ptr() % 16:  # the bulk copy of x's window
        raise ValueError(f"{name}: x must be 16-byte aligned")
    y = torch.empty(plan.ndof, dtype=x.dtype, device=x.device)
    _launch(f"vf_{name}", x.dtype, blocks.data_ptr(), x.data_ptr(),
            ptr.data_ptr(), off.data_ptr(), y.data_ptr(), plan.ndof, plan.nb,
            plan.h, _stream(x))
    LAUNCHES[name] += 1
    return y


# -- K5: fused Newmark update --------------------------------------------------


def newmark_update_reference(u1, u0, v0, a0, dt: float, gamma=0.5,
                             beta=0.25, dt_next=None):
    """(v1, a1, u_next) by ``equations.newmark``: the state update and the
    predictor of the step after it, of ``dt_next`` (by default ``dt``)."""
    v1 = newmark.newmark_v(u1, u0, v0, a0, dt, gamma, beta)
    a1 = newmark.newmark_a(u1, u0, v0, a0, dt, gamma, beta)
    dtp = dt if dt_next is None else dt_next
    return v1, a1, newmark.newmark_predict_u(u1, v1, a1, dtp)


def newmark_update_coefs_reference(u1, u0, v0, a0, coefs: torch.Tensor):
    """(v1, a1, u_next) by ``equations.newmark`` from a coefficient row
    (``equations.newmark.coefficients`` rounded to the vectors' dtype, an
    (8,) tensor): the same bits as :func:`newmark_update_reference` with the
    row's dt and dt_next, since a float tensor times a Python float rounds
    the float to the tensor's dtype first."""
    k = coefs.unbind(0)
    v1 = newmark.velocity_k(u1, u0, v0, a0, k)
    a1 = newmark.acceleration_k(u1, u0, v0, a0, k)
    return v1, a1, newmark.predict_k(u1, v1, a1, k)


def newmark_row(coefs, dtype, device) -> torch.Tensor:
    """Coefficients (``equations.newmark.coefficients``, Python floats or
    an (..., 8) float64 array) as a row of K5's: rounded from double to
    ``dtype``, on ``device``."""
    return torch.as_tensor(coefs, dtype=torch.float64).to(dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _newmark_row(device: torch.device, dtype, dt: float, gamma: float, beta: float,
                 dtp: float) -> torch.Tensor:
    """A coefficient row for the float API of :func:`newmark_update`,
    formed at its first use and kept for the next call with the same
    step."""
    return newmark_row(newmark.coefficients(dt, dtp, gamma, beta), dtype, device)


def _check_newmark(u1, *vecs, what="newmark_update", batch=False):
    """Flat vectors of one shape (with ``batch``, also (B, n) batches of
    them), one float dtype (f32/f64) and one device (CPU or CUDA)."""
    dtype, device = u1.dtype, u1.device
    if dtype not in _SUFFIX:
        raise TypeError(f"{what}: float32 or float64 expected, got {dtype}")
    for t in vecs:
        if t.dtype != dtype:
            raise TypeError(f"{what}: mixed dtypes {dtype} and {t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: tensors on {device} and {t.device}")
    if u1.dim() not in ((1, 2) if batch else (1,)) or any(t.shape != u1.shape for t in vecs):
        raise ValueError(f"{what}: flat vectors of one shape expected"
                         + (", or (B, n) batches of them" if batch else ""))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")


def newmark_update(u1, u0, v0, a0, dt: float, gamma=0.5, beta=0.25,
                   dt_next=None):
    """Newmark velocity and acceleration from ``u1`` and the previous
    state, four flat vectors of one shape, and the predictor
    ``u1 + dtp v1 + dtp^2/2 a1`` of the next step (``dtp = dt_next``, by
    default ``dt``): ``(v1, a1, u_next)``, one launch of K5 on CUDA (with a
    coefficient row on the device, formed at the first call with these
    steps and kept), the plain version on the CPU.  The time loop passes
    its rows itself: :func:`newmark_update_coefs`.  A batch of variants,
    (B, n) vectors under one row, is one launch over B n entries (K5 is
    elementwise)."""
    _check_newmark(u1, u0, v0, a0, batch=True)
    if u1.device.type == "cpu":
        return newmark_update_reference(u1, u0, v0, a0, dt, gamma, beta, dt_next)
    dt = float(dt)
    row = _newmark_row(u1.device, u1.dtype, dt, float(gamma), float(beta),
                       dt if dt_next is None else float(dt_next))
    return _newmark_launch(u1, u0, v0, a0, row)


def newmark_update_coefs(u1, u0, v0, a0, coefs: torch.Tensor):
    """:func:`newmark_update` with the step's coefficients as a row on the
    vectors' device, in their dtype (:func:`newmark_row`; a contiguous (8,)
    tensor, for example a row of a run's table): K5 reads it from device
    memory, so a CUDA graph of the step takes each replay's row.  Batches
    of (B, n) vectors as :func:`newmark_update`."""
    _check_newmark(u1, u0, v0, a0, batch=True)
    if (coefs.dtype != u1.dtype or tuple(coefs.shape) != (newmark.NCOEFS,)
            or coefs.device != u1.device):
        raise ValueError(f"newmark_update: coefficients must be a {u1.dtype} row of"
                         f" {newmark.NCOEFS} on {u1.device}, got {coefs.dtype}"
                         f" {tuple(coefs.shape)} on {coefs.device}")
    if u1.device.type == "cpu":
        return newmark_update_coefs_reference(u1, u0, v0, a0, coefs)
    return _newmark_launch(u1, u0, v0, a0, coefs)


def _newmark_launch(u1, u0, v0, a0, coefs: torch.Tensor):
    """Launch K5 on checked CUDA vectors with the row ``coefs``; a (B, n)
    batch is one launch over its B n entries."""
    if not (u1.is_contiguous() and u0.is_contiguous() and v0.is_contiguous()
            and a0.is_contiguous() and coefs.is_contiguous()):
        raise ValueError("newmark_update: inputs must be contiguous")
    if u1.dim() == 2:
        outs = _newmark_launch(*(t.reshape(-1) for t in (u1, u0, v0, a0)), coefs)
        return tuple(o.view(u1.shape) for o in outs)
    dtype, device = u1.dtype, u1.device
    n = u1.shape[0]
    lead = u1.data_ptr() % 16 // u1.element_size()
    if lead:  # outputs in u1's 16-byte phase
        v1, a1, u_next = (torch.empty(lead + n, dtype=dtype, device=device)[lead:]
                          for _ in range(3))
    else:
        v1, a1, u_next = (torch.empty(n, dtype=dtype, device=device),
                          torch.empty(n, dtype=dtype, device=device),
                          torch.empty(n, dtype=dtype, device=device))
    err = _newmark_fn(dtype)(u1.data_ptr(), u0.data_ptr(), v0.data_ptr(),
                             a0.data_ptr(), v1.data_ptr(), a1.data_ptr(),
                             u_next.data_ptr(), n, coefs.data_ptr(), _stream(u1))
    if err != 0:
        raise RuntimeError(f"vf_newmark_{_SUFFIX[dtype]} launch failed: cudaError_t {err}")
    LAUNCHES["newmark"] += 1
    return v1, a1, u_next


@functools.lru_cache(maxsize=None)
def _newmark_fn(dtype):
    """K5's entry point for ``dtype`` (the library is built at first use)."""
    return getattr(_lib(), f"vf_newmark_{_SUFFIX[dtype]}")


# -- K5T: K5's backward, and the autograd.Function around K5 -------------------

NEWMARK_T_SLOTS = 1024  # K5T's slots a device (csrc/ops.cu: kNewmarkTSlots)

# (device index, raw stream, capture id) -> the slot of K5T's launches there
_T_SLOTS: dict = {}
_T_SLOTS_LOCK = threading.Lock()


def newmark_update_t_reference(vb1, ab1, u1, u0, v0, a0, coefs: torch.Tensor):
    """The cotangents of K5's inputs ``(ub1, ub0, vb0, ab0, row_bar)`` from
    those of ``v1`` and ``a1`` (``vb1``, ``ab1``; the predictor ``u_next``
    is not differentiated), with K5's coefficient row ``coefs``
    (c1, c2, c3, c4, c5, dt, dtp, c): the transpose of
    ``v1 = c1 (u1 - u0) - c2 v0 - c3 a0`` and
    ``a1 = c4 ((u1 - u0) - dt v0) - c5 a0``, rounded in the order K5T
    rounds them; ``row_bar`` (8,) holds the sums over the entries."""
    k = coefs.unbind(0)
    ub1 = k[0] * vb1 + k[3] * ab1
    c4a = k[3] * ab1
    du = u1 - u0
    row_bar = torch.stack([
        (vb1 * du).sum(), -(vb1 * v0).sum(), -(vb1 * a0).sum(),
        (ab1 * (du - k[5] * v0)).sum(), -(ab1 * a0).sum(), -(c4a * v0).sum(),
        coefs.new_zeros(()), coefs.new_zeros(()),
    ])
    return ub1, -ub1, -(k[1] * vb1 + k[5] * c4a), -(k[2] * vb1 + k[4] * ab1), row_bar


def newmark_update_t_batch_reference(vb1, ab1, u1, u0, v0, a0, coefs: torch.Tensor):
    """:func:`newmark_update_t_reference` of a batch: (B, n) vectors under
    one coefficient row, the row's cotangent (B, 8), a row of sums a
    variant (sums over the last axis)."""
    k = coefs.unbind(0)
    ub1 = k[0] * vb1 + k[3] * ab1
    c4a = k[3] * ab1
    du = u1 - u0
    zero = vb1.new_zeros(vb1.shape[:-1])
    row_bar = torch.stack([
        (vb1 * du).sum(-1), -(vb1 * v0).sum(-1), -(vb1 * a0).sum(-1),
        (ab1 * (du - k[5] * v0)).sum(-1), -(ab1 * a0).sum(-1), -(c4a * v0).sum(-1),
        zero, zero,
    ], dim=-1)
    return ub1, -ub1, -(k[1] * vb1 + k[5] * c4a), -(k[2] * vb1 + k[4] * ab1), row_bar


def newmark_update_t(vb1, ab1, u1, u0, v0, a0, coefs: torch.Tensor):
    """K5's backward: K5T on CUDA, the plain
    :func:`newmark_update_t_reference` on the CPU.  A batch of (B, n)
    vectors under one row takes :func:`newmark_update_t_batch`.

    K5T is one launch (programmatic dependent launch) of up to one CTA an
    SM.  Each CTA writes its six partial sums of the row's cotangent and
    takes a ticket from an arrival counter; the CTA that takes the last
    adds the partial sums in CTA order, so the row's bits do not depend on
    the order of arrival.  The counter and the partial sums are a slot of
    static device memory that holds one launch at a time
    (:func:`_newmark_t_slot`).  The outputs are views of one allocation,
    the vectors in u1's 16-byte phase."""
    if u1.dim() == 2:
        return newmark_update_t_batch(vb1, ab1, u1, u0, v0, a0, coefs)
    _check_newmark_t(vb1, ab1, u1, u0, v0, a0, coefs)
    if u1.device.type == "cpu":
        return newmark_update_t_reference(vb1, ab1, u1, u0, v0, a0, coefs)
    ins = (vb1, ab1, u1, u0, v0, a0, coefs)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("newmark_update_t: inputs must be contiguous")
    n = u1.shape[0]
    if n == 0:
        raise ValueError("newmark_update_t: empty vectors")
    ub1, ub0, vb0, ab0, row_bar = _newmark_t_outputs(u1)
    stream = _stream(u1)
    slot = _newmark_t_slot(u1.get_device(), stream, _capture_id(stream))
    err = _newmark_t_fn(u1.dtype)(
        vb1.data_ptr(), ab1.data_ptr(), u1.data_ptr(), u0.data_ptr(), v0.data_ptr(),
        a0.data_ptr(), coefs.data_ptr(), ub1.data_ptr(), ub0.data_ptr(), vb0.data_ptr(),
        ab0.data_ptr(), row_bar.data_ptr(), slot, n, stream)
    if err != 0:
        raise RuntimeError(f"vf_newmark_t_{_SUFFIX[u1.dtype]} launch failed: cudaError_t {err}")
    LAUNCHES["newmark_t"] += 1
    return ub1, ub0, vb0, ab0, row_bar


def _check_newmark_t(vb1, ab1, u1, u0, v0, a0, coefs, batch=False):
    _check_newmark(u1, u0, v0, a0, vb1, ab1, what="newmark_update_t", batch=batch)
    if (coefs.dtype != u1.dtype or tuple(coefs.shape) != (newmark.NCOEFS,)
            or coefs.device != u1.device):
        raise ValueError(f"newmark_update_t: coefficients must be a {u1.dtype} row of"
                         f" {newmark.NCOEFS} on {u1.device}")


def newmark_update_t_batch(vb1, ab1, u1, u0, v0, a0, coefs: torch.Tensor):
    """K5's backward over a batch of variants: (B, n) vectors under one
    coefficient row, and the row's cotangent of each variant, (B, 8).  On
    CUDA one launch of K5T's batched kernel, a CTA a variant (its grid's
    variant axis): the CTA adds its variant's six sums as K5T's CTAs add
    theirs (each thread in entry order, an xor tree in each warp, the warps
    in order), so each variant's row is one ordered sum, whatever the order
    in which the CTAs run, with no partial sums to meet and no slot.  On
    the CPU :func:`newmark_update_t_batch_reference`."""
    _check_newmark_t(vb1, ab1, u1, u0, v0, a0, coefs, batch=True)
    if u1.dim() != 2:
        raise ValueError("newmark_update_t_batch: (B, n) vectors expected")
    if u1.device.type == "cpu":
        return newmark_update_t_batch_reference(vb1, ab1, u1, u0, v0, a0, coefs)
    ins = (vb1, ab1, u1, u0, v0, a0, coefs)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("newmark_update_t: inputs must be contiguous")
    B, n = u1.shape
    if B == 0 or n == 0:
        raise ValueError("newmark_update_t: empty vectors")
    ub1, ub0, vb0, ab0 = (torch.empty_like(u1) for _ in range(4))
    row_bar = torch.empty((B, newmark.NCOEFS), dtype=u1.dtype, device=u1.device)
    err = _newmark_t_batch_fn(u1.dtype)(
        vb1.data_ptr(), ab1.data_ptr(), u1.data_ptr(), u0.data_ptr(), v0.data_ptr(),
        a0.data_ptr(), coefs.data_ptr(), ub1.data_ptr(), ub0.data_ptr(), vb0.data_ptr(),
        ab0.data_ptr(), row_bar.data_ptr(), B, n, _stream(u1))
    if err != 0:
        raise RuntimeError(f"vf_newmark_t_batch_{_SUFFIX[u1.dtype]} launch failed:"
                           f" cudaError_t {err}")
    LAUNCHES["newmark_t"] += 1
    return ub1, ub0, vb0, ab0, row_bar


def _newmark_t_outputs(u1):
    """K5T's four vector cotangents and the row's cotangent as views of one
    allocation: each vector in u1's 16-byte phase within its own span of
    whole 16-byte vectors."""
    n, es = u1.shape[0], u1.element_size()
    lead = u1.data_ptr() % 16 // es
    span = -(-(lead + n) * es // 16) * 16 // es
    block = torch.empty(4 * span + newmark.NCOEFS, dtype=u1.dtype, device=u1.device)
    vecs = block.as_strided((4, n), (span, 1), lead).unbind(0)
    return (*vecs, block.as_strided((newmark.NCOEFS,), (1,), 4 * span))


def _capture_id(stream: int) -> int:
    """The id of the CUDA graph capture that ``stream`` (the current
    stream) takes part in, 0 when it is not capturing."""
    if not torch.cuda.is_current_stream_capturing():
        return 0
    out = ctypes.c_ulonglong(0)
    err = _lib().vf_capture_id(stream, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"vf_capture_id failed: cudaError_t {err}")
    return out.value


def _newmark_t_slot(device: int, stream: int, capture: int) -> int:
    """K5T's slot (arrival counter and partial sums) for a launch on
    ``stream`` of ``device``, inside the graph capture ``capture`` (0:
    eager).  A slot holds one launch at a time, so the launches that share
    one must be ordered: eager launches share their stream's, which orders
    them; captured ones share their capture's and stream's, since a graph
    is replayed on any stream, beside eager work and other graphs, but
    never beside itself.  Slots are never given back: a device has
    ``NEWMARK_T_SLOTS`` for its streams and captures together."""
    key = (device, stream, capture)
    slot = _T_SLOTS.get(key)
    if slot is not None:
        return slot
    with _T_SLOTS_LOCK:
        if key not in _T_SLOTS:
            taken = sum(k[0] == device for k in _T_SLOTS)
            if taken >= NEWMARK_T_SLOTS:
                raise RuntimeError(f"newmark_update_t: more than {NEWMARK_T_SLOTS} streams and"
                                   f" graph captures on cuda:{device}")
            _T_SLOTS[key] = taken
        return _T_SLOTS[key]


@functools.lru_cache(maxsize=None)
def _newmark_t_fn(dtype):
    """K5T's entry point for ``dtype`` (the library is built at first use)."""
    return getattr(_lib(), f"vf_newmark_t_{_SUFFIX[dtype]}")


@functools.lru_cache(maxsize=None)
def _newmark_t_batch_fn(dtype):
    """K5T's batched entry point for ``dtype``."""
    return getattr(_lib(), f"vf_newmark_t_batch_{_SUFFIX[dtype]}")


def _batch_first(info, in_dims, *tensors):
    """``torch.func.vmap`` rule inputs with the batch axis first: a tensor
    without one is expanded to the batch, and each is made contiguous."""
    return tuple((t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape))
                 .contiguous() for t, d in zip(tensors, in_dims))


class _NewmarkStepT(torch.autograd.Function):
    """K5T (:func:`newmark_update_t`) as a Function, so that the backward
    of :class:`_NewmarkStep` runs under ``torch.func.vmap`` (a vmapped
    gradient): its vmap rule is one batched launch
    (:func:`newmark_update_t_batch`), a row cotangent a variant.  Never
    differentiated itself."""

    @staticmethod
    def forward(vb1, ab1, u1, u0, v0, a0, coefs):
        return newmark_update_t(vb1, ab1, u1, u0, v0, a0, coefs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, vb1, ab1, u1, u0, v0, a0, coefs):
        if in_dims[6] is not None:
            raise NotImplementedError("K5T takes one coefficient row for the batch")
        vecs = _batch_first(info, in_dims[:6], vb1, ab1, u1, u0, v0, a0)
        outs = _NewmarkStepT.apply(*(v.reshape(-1, v.shape[-1]) for v in vecs), coefs)
        shape = vecs[0].shape
        outs = tuple(o.reshape(shape) for o in outs[:4]) + (
            outs[4].reshape(shape[:-1] + (newmark.NCOEFS,)),)
        return outs, (0,) * 5


class _NewmarkStep(torch.autograd.Function):
    """K5 (:func:`newmark_update_coefs`) with K5T as its backward and two
    K5 launches as its tangent.  The predictor ``u_next`` is marked
    non-differentiable: it only seeds the next step's Newton solve, whose
    converged state does not depend on it."""

    @staticmethod
    def forward(u1, u0, v0, a0, coefs):
        return newmark_update_coefs(u1, u0, v0, a0, coefs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)
        ctx.mark_non_differentiable(output[2])

    @staticmethod
    def backward(ctx, vb1, ab1, _):
        u1, u0, v0, a0, coefs = ctx.saved_tensors
        vb1 = torch.zeros_like(u1) if vb1 is None else vb1.contiguous()
        ab1 = torch.zeros_like(u1) if ab1 is None else ab1.contiguous()
        if torch._C._functorch.is_functorch_wrapped_tensor(vb1):
            # a vmapped gradient: through apply, so that K5T gets its
            # batched launch (_NewmarkStepT.vmap)
            return _NewmarkStepT.apply(vb1, ab1, u1, u0, v0, a0, coefs)
        *vecs, row_bar = newmark_update_t(vb1, ab1, u1, u0, v0, a0, coefs)
        if row_bar.dim() > coefs.dim():  # (B, n) vectors under one row
            row_bar = row_bar.sum(0)
        return (*vecs, row_bar)

    @staticmethod
    def jvp(ctx, du1, du0, dv0, da0, dcoefs):
        # v1 is linear in the vectors for a fixed row and in the row for
        # fixed vectors, so its tangent is K5 on the tangents with the row
        # plus K5 on the vectors with the row's tangent.  a1 = c4 ((u1 -
        # u0) - dt v0) - c5 a0 has the product c4 dt, which K5 on the
        # row's tangent takes as dc4 ddt: the rest of d(c4 dt) v0, (dc4 (dt
        # - ddt) + c4 ddt) v0, is subtracted.  The predictor's tangent is
        # not formed (u_next is not differentiated).  K5 runs through
        # apply: under torch.func the rule sees the transform's tensors,
        # which the Function hands to the kernel unwrapped.
        u1, u0, v0, a0, coefs = ctx.saved_tensors
        vecs = [torch.zeros_like(u1) if t is None else t.contiguous()
                for t in (du1, du0, dv0, da0)]
        v1_dot, a1_dot, _ = _NewmarkStep.apply(*vecs, coefs)
        if dcoefs is None:
            return v1_dot, a1_dot, None
        dc = dcoefs.contiguous()
        v1_row, a1_row, _ = _NewmarkStep.apply(u1, u0, v0, a0, dc)
        c4, dt, dc4, ddt = coefs[3], coefs[5], dc[3], dc[5]
        a1_row = a1_row - (dc4 * (dt - ddt) + c4 * ddt) * v0
        return v1_dot + v1_row, a1_dot + a1_row, None

    @staticmethod
    def vmap(info, in_dims, u1, u0, v0, a0, coefs):
        # a batch of vectors under one row is one launch over all of them
        if in_dims[4] is not None:
            raise NotImplementedError("K5 takes one coefficient row for the batch")
        vecs = _batch_first(info, in_dims[:4], u1, u0, v0, a0)
        shape = vecs[0].shape
        outs = _NewmarkStep.apply(*(v.reshape(-1, shape[-1]) for v in vecs), coefs)
        return tuple(o.reshape(shape) for o in outs), (0, 0, 0)


def newmark_step(u1, u0, v0, a0, coefs: torch.Tensor):
    """:func:`newmark_update_coefs` as a differentiable function of the four
    vectors and the coefficient row (K5 forward, K5T backward, two K5
    launches forward-mode)."""
    return _NewmarkStep.apply(u1, u0, v0, a0, coefs)


# -- K6: block-Thomas sweep ----------------------------------------------------

# (factor dtype, vector dtype) -> entry-point suffix in csrc/btd.cu
_SWEEP_TYPES = {
    (torch.bfloat16, torch.float64): "bf16_f64",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float64, torch.float64): "f64_f64",
    (torch.float32, torch.float32): "f32_f32",
}
# the row-block sizes K6T is compiled for, h = 1 .. 4 blocks of 128 (the 2D
# meshes, and 2Bt of the complex embedding; csrc/cluster.cuh, VF_BT_T_CASES),
# and K6 for these and h = 10 (the 45.8k-dof extruded 3D mesh; 3D gradients
# wait)
SWEEP_T_WIDTHS = (128, 256, 384, 512)
SWEEP_WIDTHS = SWEEP_T_WIDTHS + (1280,)
# CTAs a cluster for each factor dtype (csrc/cluster.cuh, cluster_size): the
# faster of 8 and 16 at 93 row blocks of 256 on an H100 (PERF.md section 6)
SWEEP_CLUSTER = {torch.bfloat16: 8, torch.float32: 8, torch.float64: 16}
SMEM_LIMIT = 232448  # shared memory a CTA can use on Hopper (227 KB)
_MAX_WARPS = 16  # consumer warps a CTA
_MAX_STAGES = 16  # ring slots
_BAR_BYTES = (2 * _MAX_STAGES + 2) * 8
# K6 takes the number of slabs beside K6T's arguments
_SWEEP_SIGNATURES = {f"vf_btd_sweep{t}_{s}": [_P, _P, _P] + [_I] * (4 + n) + [_P]
                     for s in _SWEEP_TYPES.values() for t, n in (("", 1), ("_t", 0))}
_SWEEP_SIGNATURES["vf_btd_sweep_plan"] = [_I, _I, _P]
_SWEEP_SIGNATURES["vf_btd_sweep_t_plan"] = [_I, _I, _P]


class SweepPlan(NamedTuple):
    """K6's launch plan for one row-block width and factor dtype (the
    ``make_plan`` of ``csrc/cluster.cuh``; the kernel refuses any other
    cluster size)."""

    cluster: int  # CTAs in the cluster
    rows_per_cta: int  # rows of every row block a CTA owns
    rows_per_warp: int  # rows a consumer warp takes from a ring slot
    warps: int  # consumer warps a CTA (one producer warp besides)
    stage_rows: int  # rows a ring slot holds
    stages_per_block: int  # ring slots a row block takes
    ring: int  # ring slots
    smem_bytes: int  # dynamic shared memory a CTA
    threads: int  # threads a CTA


@functools.lru_cache(maxsize=None)
def sweep_plan(bt: int, factor_dtype, vector_dtype) -> SweepPlan:
    """The launch plan of K6 for row blocks of ``bt``: each of the
    ``SWEEP_CLUSTER`` CTAs of the factor dtype owns ``bt / cluster``
    contiguous rows of every block; a consumer warp takes rows a whole
    32-bit word of the carried vector at a time, as many warps (up to 16) as
    leave a ring of at least two slots; the ring has as many slots (of as
    many rows as the warps take together) as fit in ``SMEM_LIMIT`` beside
    the carried vector's two buffers and the mbarriers."""
    if (factor_dtype, vector_dtype) not in _SWEEP_TYPES:
        raise TypeError(f"btd_sweep: factor/vector dtypes {factor_dtype},"
                        f" {vector_dtype} not supported ({list(_SWEEP_TYPES)})")
    if bt not in SWEEP_WIDTHS:
        raise ValueError(f"btd_sweep: kernel built for row blocks {SWEEP_WIDTHS},"
                         f" got {bt}")
    cluster = SWEEP_CLUSTER[factor_dtype]
    es = factor_dtype.itemsize
    rows = bt // cluster
    rpw = 4 // es if es < 4 else 1
    units = rows // rpw

    def room(stage_rows):  # slots of ``stage_rows`` rows that fit
        return (SMEM_LIMIT - 2 * bt * es - _BAR_BYTES) // (stage_rows * bt * es)

    # the most warps that divide the units and leave at least two slots
    warps = max(d for d in range(1, min(_MAX_WARPS, units) + 1)
                if units % d == 0 and room(d * rpw) >= 2)
    stage_rows = warps * rpw
    stage_bytes = stage_rows * bt * es
    ring = min(_MAX_STAGES, room(stage_rows))
    return SweepPlan(cluster, rows, rpw, warps, stage_rows, rows // stage_rows,
                     ring, ring * stage_bytes + 2 * bt * es + _BAR_BYTES,
                     (warps + 1) * 32)


def built_sweep_plan(bt: int, factor_dtype) -> SweepPlan:
    """The plan compiled into ``csrc/btd.cu`` (its ``make_plan``) for row
    blocks of ``bt`` and the factor dtype, read from the built library (this
    builds it), to hold :func:`sweep_plan` to it."""
    vals = (ctypes.c_int * len(SweepPlan._fields))()
    err = _sweep_lib().vf_btd_sweep_plan(factor_dtype.itemsize, bt, vals)
    if err != 0:
        raise ValueError(f"vf_btd_sweep_plan: cudaError_t {err} for {bt}, {factor_dtype}")
    return SweepPlan(*vals)


def _sweep_lib():
    return cuda_build.load("btd.cu", _SWEEP_SIGNATURES)


def factor_matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the last two axes of ``A`` (``(..., Bt, Bt)`` by
    ``(..., Bt)``), in the vector's dtype, with the JAX package's rule for
    stored factors (``vf_fem_tpu.solvers.btd._dot``): when ``A``'s dtype
    differs from ``x``'s, ``x`` is cast to ``A``'s dtype, the products
    accumulate in f32 and the result is cast back to ``x``'s dtype."""
    if A.dtype != x.dtype:
        y = A.float() @ x.to(A.dtype).float().unsqueeze(-1)
        return y.squeeze(-1).to(x.dtype)
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def btd_sweep_reference(A: torch.Tensor, g: torch.Tensor,
                        reverse: bool = False) -> torch.Tensor:
    """The serial sweep ``y_i = g_i - A_i y_{i-1}`` from ``y_{-1} = 0``
    (``reverse=True``: ``x_i = g_i - A_i x_{i+1}`` from ``x_n = 0``), one
    :func:`factor_matvec` per row: A (n, Bt, Bt), g (n, Bt) -> (n, Bt)."""
    out = torch.empty_like(g)
    carry = torch.zeros_like(g[0])
    rows = range(g.shape[0] - 1, -1, -1) if reverse else range(g.shape[0])
    for i in rows:
        carry = g[i] - factor_matvec(A[i], carry)
        out[i] = carry
    return out


def btd_sweep_rows_reference(A: torch.Tensor, g: torch.Tensor,
                             out: torch.Tensor, reverse: bool = False):
    """Every row of a sweep's output ``out`` recomputed by the plain
    version from the previous row of ``out`` itself (``g_i - A_i out_{i-1}``,
    or ``out_{i+1}`` in reverse; no recurrence), and the bound on
    dot-product order differences of each entry: ``(ref, bound)``.  Holds
    a kernel's sweep to the plain version row by row, where order
    differences would otherwise compound along the sweep."""
    prev = torch.zeros_like(out)
    if reverse:
        prev[:-1] = out[1:]
    else:
        prev[1:] = out[:-1]
    acc = torch.float32 if A.dtype != g.dtype else A.dtype
    bound = dot_order_bound(factor_matvec(A.abs(), prev.abs()), A.shape[-1],
                            acc)
    return g - factor_matvec(A, prev), bound


def btd_sweep_slabs_reference(A: torch.Tensor, g: torch.Tensor,
                              reverse: bool = False) -> torch.Tensor:
    """:func:`btd_sweep_reference` over each slab: A (S, n, Bt, Bt),
    g (S, n, Bt) -> (S, n, Bt)."""
    return torch.stack([btd_sweep_reference(a, x, reverse) for a, x in zip(A, g)])


def btd_sweep(A: torch.Tensor, g: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """One serial sweep of the block-Thomas solve (K6 on CUDA, one
    thread-block cluster launched with :func:`sweep_plan`; the plain
    :func:`btd_sweep_reference` on the CPU).  Factor and vector dtypes:
    (bf16, f64), (bf16, f32), (f64, f64) or (f32, f32).

    With A (S, n, Bt, Bt) and g (S, n, Bt) it runs the sweep over each of
    S independent slabs (the SPIKE solver's local sweeps): one launch of S
    clusters, each bit for bit a launch of its slab alone, or
    :func:`btd_sweep_slabs_reference` on the CPU."""
    if (A.dim() not in (3, 4) or A.shape[-1] != A.shape[-2]
            or tuple(g.shape) != tuple(A.shape[:-1])):
        raise ValueError(f"btd_sweep: A {tuple(A.shape)}, g {tuple(g.shape)}")
    suffix = _SWEEP_TYPES.get((A.dtype, g.dtype))
    if suffix is None:
        raise TypeError(f"btd_sweep: factor/vector dtypes {A.dtype}, {g.dtype}"
                        f" not supported ({list(_SWEEP_TYPES)})")
    if A.device != g.device:
        raise ValueError(f"btd_sweep: tensors on {A.device} and {g.device}")
    if g.device.type == "cpu":
        if g.dim() == 3:
            return btd_sweep_slabs_reference(A, g, reverse)
        return btd_sweep_reference(A, g, reverse)
    if g.device.type != "cuda":
        raise ValueError(f"btd_sweep: unsupported device {g.device}")
    if not (A.is_contiguous() and g.is_contiguous()):
        raise ValueError("btd_sweep: inputs must be contiguous")
    return _sweep_launch(A, g, reverse, sweep_plan(g.shape[-1], A.dtype, g.dtype))


def _sweep_launch(A: torch.Tensor, g: torch.Tensor, reverse: bool,
                  plan: SweepPlan) -> torch.Tensor:
    """Launch K6 with ``plan``'s cluster size on checked CUDA tensors, one
    cluster a slab."""
    n, bt = g.shape[-2:]
    slabs = g.shape[0] if g.dim() == 3 else 1
    out = torch.empty_like(g)
    fn = f"vf_btd_sweep_{_SWEEP_TYPES[(A.dtype, g.dtype)]}"
    err = getattr(_sweep_lib(), fn)(A.data_ptr(), g.data_ptr(), out.data_ptr(), n, bt,
                                    int(reverse), plan.cluster, slabs, _stream(g))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err} (plan {plan})")
    LAUNCHES["btd_sweep_slabs" if g.dim() == 3 else "btd_sweep"] += 1
    return out


# -- K6T: the transposed block-Thomas sweep ------------------------------------


class SweepTPlan(NamedTuple):
    """K6T's launch plan for one row-block width and factor dtype (the
    ``make_t_plan`` of ``csrc/btd.cu``)."""

    cluster: int  # CTAs in the cluster (K6's)
    cols_per_cta: int  # output entries a CTA owns: a column box of every block
    warps: int  # consumer warps: the 16-byte chunks of a box row
    stage_rows: int  # box rows a ring slot holds (at most 256)
    stages_per_block: int  # ring slots a row block takes
    box_bytes: int  # the inner width of a tensor-map box, its swizzle span
    ring: int  # ring slots
    smem_bytes: int  # dynamic shared memory a CTA (1024 of it to align the ring)
    threads: int  # threads a CTA (one producer warp besides)


@functools.lru_cache(maxsize=None)
def sweep_t_plan(bt: int, factor_dtype, vector_dtype) -> SweepTPlan:
    """The launch plan of K6T for row blocks of ``bt``: K6's cluster; each
    CTA owns ``bt / cluster`` columns, whose box rows a consumer warp a
    16-byte chunk reads; a ring slot holds up to 256 box rows, loaded as
    tensor-map boxes of 128, 64 or 32 bytes (the widest that divides a box
    row) swizzled over that span, and the ring as many slots as fit in
    ``SMEM_LIMIT`` beside the carried vector's two buffers, the mbarriers
    and 1024 bytes to align the ring."""
    if bt not in SWEEP_T_WIDTHS:
        raise ValueError(f"btd_sweep_t: kernel built for row blocks {SWEEP_T_WIDTHS},"
                         f" got {bt}")
    cluster = sweep_plan(bt, factor_dtype, vector_dtype).cluster
    es = factor_dtype.itemsize
    cols = bt // cluster
    row_bytes = cols * es
    stage_rows = bt if bt <= 256 else bt // 2
    box = 128 if row_bytes % 128 == 0 else 64 if row_bytes % 64 == 0 else 32
    stage_bytes = stage_rows * row_bytes
    ring = min(_MAX_STAGES, (SMEM_LIMIT - 1024 - 2 * bt * es - _BAR_BYTES) // stage_bytes)
    return SweepTPlan(cluster, cols, row_bytes // 16, stage_rows, bt // stage_rows, box,
                      ring, 1024 + ring * stage_bytes + 2 * bt * es + _BAR_BYTES,
                      (row_bytes // 16 + 1) * 32)


def built_sweep_t_plan(bt: int, factor_dtype) -> SweepTPlan:
    """The plan compiled into ``csrc/btd.cu`` (its ``make_t_plan``) for row
    blocks of ``bt`` and the factor dtype, read from the built library (this
    builds it), to hold :func:`sweep_t_plan` to it."""
    vals = (ctypes.c_int * len(SweepTPlan._fields))()
    err = _sweep_lib().vf_btd_sweep_t_plan(factor_dtype.itemsize, bt, vals)
    if err != 0:
        raise ValueError(f"vf_btd_sweep_t_plan: cudaError_t {err} for {bt}, {factor_dtype}")
    return SweepTPlan(*vals)


def btd_sweep_t_reference(A: torch.Tensor, g: torch.Tensor,
                          reverse: bool = False) -> torch.Tensor:
    """The transposed sweep ``y_i = g_i - A_{i-1}^T y_{i-1}`` from
    ``y_0 = g_0`` (``reverse=True``: ``x_i = g_i - A_{i+1}^T x_{i+1}`` from
    ``x_{n-1} = g_{n-1}``), one :func:`factor_matvec` of a transposed block
    per row: A (n, Bt, Bt), g (n, Bt) -> (n, Bt)."""
    n = g.shape[0]
    out = torch.empty_like(g)
    rows = list(range(n - 1, -1, -1) if reverse else range(n))
    carry = g[rows[0]]
    out[rows[0]] = carry
    for i in rows[1:]:
        carry = g[i] - factor_matvec(A[i + 1 if reverse else i - 1].mT, carry)
        out[i] = carry
    return out


def btd_sweep_t_rows_reference(A: torch.Tensor, g: torch.Tensor,
                               out: torch.Tensor, reverse: bool = False):
    """:func:`btd_sweep_rows_reference` for the transposed sweep: every row
    of ``out`` recomputed by the plain version from the previous row of
    ``out`` itself, and the bound on dot-product order of each entry:
    ``(ref, bound)``."""
    ref = g.clone()
    bound = torch.zeros_like(g)
    if g.shape[0] > 1:
        if reverse:
            At, prev, rows = A[1:].mT, out[1:], slice(0, -1)
        else:
            At, prev, rows = A[:-1].mT, out[:-1], slice(1, None)
        acc = torch.float32 if A.dtype != g.dtype else A.dtype
        ref[rows] = g[rows] - factor_matvec(At, prev)
        bound[rows] = dot_order_bound(factor_matvec(At.abs(), prev.abs()),
                                      A.shape[-1], acc)
    return ref, bound


def btd_sweep_t(A: torch.Tensor, g: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """One transposed sweep of the block-Thomas adjoint solve over the
    stored blocks, shifted by one block (K6T on CUDA, one thread-block
    cluster launched with :func:`sweep_t_plan`; the plain
    :func:`btd_sweep_t_reference` on the CPU).  The dtype pairs of
    :func:`btd_sweep`."""
    if (A.dim() != 3 or A.shape[1] != A.shape[2]
            or tuple(g.shape) != tuple(A.shape[:2])):
        raise ValueError(f"btd_sweep_t: A {tuple(A.shape)}, g {tuple(g.shape)}")
    suffix = _SWEEP_TYPES.get((A.dtype, g.dtype))
    if suffix is None:
        raise TypeError(f"btd_sweep_t: factor/vector dtypes {A.dtype}, {g.dtype}"
                        f" not supported ({list(_SWEEP_TYPES)})")
    if A.device != g.device:
        raise ValueError(f"btd_sweep_t: tensors on {A.device} and {g.device}")
    if g.device.type == "cpu":
        return btd_sweep_t_reference(A, g, reverse)
    if g.device.type != "cuda":
        raise ValueError(f"btd_sweep_t: unsupported device {g.device}")
    if not (A.is_contiguous() and g.is_contiguous()):
        raise ValueError("btd_sweep_t: inputs must be contiguous")
    if A.data_ptr() % 16:  # the tensor map's base
        raise ValueError("btd_sweep_t: the factors must be 16-byte aligned")
    n, bt = g.shape
    plan = sweep_t_plan(bt, A.dtype, g.dtype)  # raises for a width it lacks
    out = torch.empty_like(g)
    fn = f"vf_btd_sweep_t_{suffix}"
    err = getattr(_sweep_lib(), fn)(A.data_ptr(), g.data_ptr(), out.data_ptr(), n, bt,
                                    int(reverse), plan.cluster, _stream(g))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err} (plan {plan})")
    LAUNCHES["btd_sweep_t"] += 1
    return out
