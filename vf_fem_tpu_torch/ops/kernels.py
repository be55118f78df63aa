"""
The solver kernels: K3 (element-by-element matvec), K4 (block-banded
matvec), K5 (fused Newmark update) and K6 (block-Thomas sweep), and the
two kernels of the gradient path: K5T (K5's backward, under the
``autograd.Function`` :func:`newmark_step`) and K6T (the transposed sweep
of ``solvers.btd.btd_solve_t``).

Counterparts of ``vf_fem_tpu/ops/pallas_kernels.py``: ``ebe_matvec``
replaces ``_ebe_matvec_kernel``, ``bsb_matvec`` replaces
``_bsb_matvec_kernel``, ``newmark_update`` replaces ``_newmark_kernel``.
``btd_sweep`` has no TPU kernel: it runs the serial sweeps of
``solvers.btd.btd_solve``, a ``lax.scan`` in the JAX package; neither has
``btd_sweep_t`` (the ``lax.scan`` of ``btd_solve_t``) nor
``newmark_update_t`` (the JAX package differentiates the Newmark relations
with its step).  The CUDA
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
from typing import NamedTuple

import torch

from .. import cuda_build
from ..equations import newmark

__all__ = [
    "LAUNCHES",
    "ebe_matvec",
    "ebe_matvec_reference",
    "bsb_matvec",
    "bsb_matvec_reference",
    "newmark_update",
    "newmark_update_coefs",
    "newmark_update_coefs_reference",
    "newmark_update_reference",
    "newmark_row",
    "newmark_step",
    "newmark_update_t",
    "newmark_update_t_reference",
    "factor_matvec",
    "btd_sweep",
    "btd_sweep_reference",
    "btd_sweep_rows_reference",
    "btd_sweep_t",
    "btd_sweep_t_reference",
    "btd_sweep_t_rows_reference",
    "sweep_plan",
    "dot_order_bound",
]

LAUNCHES = {"ebe_matvec": 0, "bsb_matvec": 0, "newmark": 0, "btd_sweep": 0,
            "newmark_t": 0, "btd_sweep_t": 0}

BSB_BLOCK = 128  # the block size K4 is compiled for
BSB_LANES = 4  # lanes a row of K4 (csrc/ops.cu: kBsbLanes), for its emulation

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {}
for _t in ("f32", "f64"):
    _SIGNATURES[f"vf_ebe_matvec_{_t}"] = [_P, _P, _P, _P, _I, _I, _P]
    _SIGNATURES[f"vf_bsb_matvec_{_t}"] = [_P] * 5 + [_I] * 3 + [_P]
    _SIGNATURES[f"vf_newmark_{_t}"] = [_P] * 7 + [_L, _P, _P]
    _SIGNATURES[f"vf_newmark_t_{_t}"] = [_P] * 13 + [_L, _P]
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


def ebe_matvec(J: torch.Tensor, x: torch.Tensor,
               dofs: torch.Tensor) -> torch.Tensor:
    """Batched element matvec through the element dof map (K3 on CUDA)."""
    _check("ebe_matvec", J, x)
    ne, nld, nld2 = J.shape
    if nld != nld2 or tuple(dofs.shape) != (ne, nld) or x.dim() != 1:
        raise ValueError(
            f"ebe_matvec: J {tuple(J.shape)}, x {tuple(x.shape)},"
            f" dofs {tuple(dofs.shape)}"
        )
    if dofs.dtype != torch.int64 or dofs.device != J.device:
        raise TypeError("ebe_matvec: dofs must be int64 on J's device")
    if J.device.type == "cpu":
        return ebe_matvec_reference(J, x, dofs)
    if not dofs.is_contiguous():
        raise ValueError("ebe_matvec: dofs must be contiguous")
    y = torch.empty((ne, nld), dtype=J.dtype, device=J.device)
    _launch("vf_ebe_matvec", J.dtype, J.data_ptr(), x.data_ptr(),
            dofs.data_ptr(), y.data_ptr(), ne, nld, _stream(J))
    LAUNCHES["ebe_matvec"] += 1
    return y


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


def bsb_matvec(plan, blocks: torch.Tensor, x: torch.Tensor,
               pattern=None) -> torch.Tensor:
    """Block-banded matvec ``y = A x`` of ``solvers.bsb`` (K4 on CUDA).
    ``plan`` is a :class:`~vf_fem_tpu_torch.solvers.bsb.BSBPlan`;
    ``pattern`` its :class:`~vf_fem_tpu_torch.solvers.bsb.MatvecPattern`
    on the device (``fill_plan(plan, device).pattern``), outside which
    ``blocks`` must be zero (as ``bsb_fill`` leaves it).  K4 reads only the
    pattern's entries and raises without one; the plain version on the CPU
    reads the whole band and ignores it."""
    _check("bsb_matvec", blocks, x)
    shape = (plan.nblk, plan.nb, plan.b, plan.b)
    if tuple(blocks.shape) != shape or tuple(x.shape) != (plan.ndof,):
        raise ValueError(
            f"bsb_matvec: blocks {tuple(blocks.shape)} (plan {shape}),"
            f" x {tuple(x.shape)} (ndof {plan.ndof})"
        )
    if x.device.type == "cpu":
        return bsb_matvec_reference(plan, blocks, x)
    return _bsb_launch(plan, blocks, x, pattern)


def _bsb_launch(plan, blocks: torch.Tensor, x: torch.Tensor,
                pattern) -> torch.Tensor:
    """Launch K4 on CUDA tensors checked against ``plan``."""
    if pattern is None:
        raise ValueError("bsb_matvec: K4 needs the plan's matvec pattern"
                         " (solvers.bsb.fill_plan(plan, device).pattern)")
    if plan.b != BSB_BLOCK:
        raise ValueError(f"bsb_matvec: kernel built for b={BSB_BLOCK}, plan"
                         f" has b={plan.b}")
    ptr, off = pattern
    for name, t, n in (("ptr", ptr, plan.ndof + 1), ("off", off, None)):
        if (t.dtype != torch.int32 or t.device != x.device or t.dim() != 1
                or not t.is_contiguous() or (n is not None and t.numel() != n)):
            raise ValueError(f"bsb_matvec: pattern.{name} must be a contiguous"
                             f" int32 vector on {x.device}"
                             + ("" if n is None else f" of {n} entries"))
    if x.data_ptr() % 16:
        raise ValueError("bsb_matvec: x must be 16-byte aligned")
    y = torch.empty(plan.ndof, dtype=x.dtype, device=x.device)
    _launch("vf_bsb_matvec", x.dtype, blocks.data_ptr(), x.data_ptr(),
            ptr.data_ptr(), off.data_ptr(), y.data_ptr(), plan.ndof, plan.nb,
            plan.h, _stream(x))
    LAUNCHES["bsb_matvec"] += 1
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


def _check_newmark(u1, u0, v0, a0):
    dtype, device = u1.dtype, u1.device
    if dtype not in _SUFFIX:
        raise TypeError(f"newmark_update: float32 or float64 expected, got {dtype}")
    for t in (u0, v0, a0):
        if t.dtype != dtype:
            raise TypeError(f"newmark_update: mixed dtypes {dtype} and {t.dtype}")
        if t.device != device:
            raise ValueError(f"newmark_update: tensors on {device} and {t.device}")
    if not (u1.shape == u0.shape == v0.shape == a0.shape) or u1.dim() != 1:
        raise ValueError("newmark_update: four flat vectors of one shape"
                         " expected")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"newmark_update: unsupported device {device}")


def newmark_update(u1, u0, v0, a0, dt: float, gamma=0.5, beta=0.25,
                   dt_next=None):
    """Newmark velocity and acceleration from ``u1`` and the previous
    state, four flat vectors of one shape, and the predictor
    ``u1 + dtp v1 + dtp^2/2 a1`` of the next step (``dtp = dt_next``, by
    default ``dt``): ``(v1, a1, u_next)``, one launch of K5 on CUDA (with a
    coefficient row on the device, formed at the first call with these
    steps and kept), the plain version on the CPU.  The time loop passes
    its rows itself: :func:`newmark_update_coefs`."""
    _check_newmark(u1, u0, v0, a0)
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
    memory, so a CUDA graph of the step takes each replay's row."""
    _check_newmark(u1, u0, v0, a0)
    if (coefs.dtype != u1.dtype or tuple(coefs.shape) != (newmark.NCOEFS,)
            or coefs.device != u1.device):
        raise ValueError(f"newmark_update: coefficients must be a {u1.dtype} row of"
                         f" {newmark.NCOEFS} on {u1.device}, got {coefs.dtype}"
                         f" {tuple(coefs.shape)} on {coefs.device}")
    if u1.device.type == "cpu":
        return newmark_update_coefs_reference(u1, u0, v0, a0, coefs)
    return _newmark_launch(u1, u0, v0, a0, coefs)


def _newmark_launch(u1, u0, v0, a0, coefs: torch.Tensor):
    """Launch K5 on checked CUDA vectors with the row ``coefs``."""
    if not (u1.is_contiguous() and u0.is_contiguous() and v0.is_contiguous()
            and a0.is_contiguous() and coefs.is_contiguous()):
        raise ValueError("newmark_update: inputs must be contiguous")
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

NEWMARK_T_MAX_CTAS = 1024  # csrc/ops.cu: kNewmarkTMaxCtas
NEWMARK_T_SUMS = 6  # partial sums a CTA writes (the row's nonzero entries)


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


def newmark_update_t(vb1, ab1, u1, u0, v0, a0, coefs: torch.Tensor):
    """K5's backward (K5T on CUDA, one call of two launches: the vector
    cotangents with each CTA's partial sums of the row's, then their sum in
    CTA order; the plain :func:`newmark_update_t_reference` on the CPU)."""
    _check_newmark(vb1, ab1, u1, u0)
    _check_newmark(u1, u0, v0, a0)
    if (coefs.dtype != u1.dtype or tuple(coefs.shape) != (newmark.NCOEFS,)
            or coefs.device != u1.device):
        raise ValueError(f"newmark_update_t: coefficients must be a {u1.dtype} row of"
                         f" {newmark.NCOEFS} on {u1.device}")
    if u1.device.type == "cpu":
        return newmark_update_t_reference(vb1, ab1, u1, u0, v0, a0, coefs)
    ins = (vb1, ab1, u1, u0, v0, a0, coefs)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("newmark_update_t: inputs must be contiguous")
    n = u1.shape[0]
    if n == 0:
        raise ValueError("newmark_update_t: empty vectors")
    outs = [torch.empty_like(u1) for _ in range(4)]
    row_bar = torch.empty(newmark.NCOEFS, dtype=u1.dtype, device=u1.device)
    partial = torch.empty(NEWMARK_T_SUMS * NEWMARK_T_MAX_CTAS, dtype=u1.dtype,
                          device=u1.device)
    fn = f"vf_newmark_t_{_SUFFIX[u1.dtype]}"
    err = getattr(_lib(), fn)(*(t.data_ptr() for t in ins),
                              *(t.data_ptr() for t in outs), row_bar.data_ptr(),
                              partial.data_ptr(), n, _stream(u1))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")
    LAUNCHES["newmark_t"] += 1
    return (*outs, row_bar)


class _NewmarkStep(torch.autograd.Function):
    """K5 (:func:`newmark_update_coefs`) with K5T as its backward.  The
    predictor ``u_next`` is marked non-differentiable: it only seeds the
    next step's Newton solve, whose converged state does not depend on it."""

    @staticmethod
    def forward(u1, u0, v0, a0, coefs):
        return newmark_update_coefs(u1, u0, v0, a0, coefs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.mark_non_differentiable(output[2])

    @staticmethod
    def backward(ctx, vb1, ab1, _):
        u1, u0, v0, a0, coefs = ctx.saved_tensors
        vb1 = torch.zeros_like(u1) if vb1 is None else vb1.contiguous()
        ab1 = torch.zeros_like(u1) if ab1 is None else ab1.contiguous()
        return newmark_update_t(vb1, ab1, u1, u0, v0, a0, coefs)


def newmark_step(u1, u0, v0, a0, coefs: torch.Tensor):
    """:func:`newmark_update_coefs` as a differentiable function of the four
    vectors and the coefficient row (K5 forward, K5T backward)."""
    return _NewmarkStep.apply(u1, u0, v0, a0, coefs)


# -- K6: block-Thomas sweep ----------------------------------------------------

# (factor dtype, vector dtype) -> entry-point suffix in csrc/btd.cu
_SWEEP_TYPES = {
    (torch.bfloat16, torch.float64): "bf16_f64",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float64, torch.float64): "f64_f64",
    (torch.float32, torch.float32): "f32_f32",
}
SWEEP_WIDTHS = (128, 256, 384, 512)  # the row-block sizes K6 is compiled for
# CTAs a cluster for each factor dtype (csrc/cluster.cuh, cluster_size): the
# faster of 8 and 16 at 93 row blocks of 256 on an H100 (PERF.md section 6)
SWEEP_CLUSTER = {torch.bfloat16: 8, torch.float32: 8, torch.float64: 16}
SMEM_LIMIT = 232448  # shared memory a CTA can use on Hopper (227 KB)
_MAX_WARPS = 16  # consumer warps a CTA
_MAX_STAGES = 16  # ring slots
_BAR_BYTES = (2 * _MAX_STAGES + 2) * 8
_SWEEP_SIGNATURES = {f"vf_btd_sweep{t}_{s}": [_P, _P, _P] + [_I] * 4 + [_P]
                     for s in _SWEEP_TYPES.values() for t in ("", "_t")}
_SWEEP_SIGNATURES["vf_btd_sweep_plan"] = [_I, _I, _P]


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
    32-bit word of the carried vector at a time; the ring has as many slots
    (of as many rows as the warps take together) as fit in ``SMEM_LIMIT``
    beside the carried vector's two buffers and the mbarriers."""
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
    warps = max(d for d in range(1, min(_MAX_WARPS, units) + 1) if units % d == 0)
    stage_rows = warps * rpw
    stage_bytes = stage_rows * bt * es
    ring = min(_MAX_STAGES, (SMEM_LIMIT - 2 * bt * es - _BAR_BYTES) // stage_bytes)
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


def btd_sweep(A: torch.Tensor, g: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """One serial sweep of the block-Thomas solve (K6 on CUDA, one
    thread-block cluster launched with :func:`sweep_plan`; the plain
    :func:`btd_sweep_reference` on the CPU).  Factor and vector dtypes:
    (bf16, f64), (bf16, f32), (f64, f64) or (f32, f32)."""
    if (A.dim() != 3 or A.shape[1] != A.shape[2]
            or tuple(g.shape) != tuple(A.shape[:2])):
        raise ValueError(f"btd_sweep: A {tuple(A.shape)}, g {tuple(g.shape)}")
    suffix = _SWEEP_TYPES.get((A.dtype, g.dtype))
    if suffix is None:
        raise TypeError(f"btd_sweep: factor/vector dtypes {A.dtype}, {g.dtype}"
                        f" not supported ({list(_SWEEP_TYPES)})")
    if A.device != g.device:
        raise ValueError(f"btd_sweep: tensors on {A.device} and {g.device}")
    if g.device.type == "cpu":
        return btd_sweep_reference(A, g, reverse)
    if g.device.type != "cuda":
        raise ValueError(f"btd_sweep: unsupported device {g.device}")
    if not (A.is_contiguous() and g.is_contiguous()):
        raise ValueError("btd_sweep: inputs must be contiguous")
    return _sweep_launch(A, g, reverse, sweep_plan(g.shape[1], A.dtype, g.dtype))


def _sweep_launch(A: torch.Tensor, g: torch.Tensor, reverse: bool,
                  plan: SweepPlan) -> torch.Tensor:
    """Launch K6 with ``plan``'s cluster size on checked CUDA tensors."""
    n, bt = g.shape
    out = torch.empty_like(g)
    fn = f"vf_btd_sweep_{_SWEEP_TYPES[(A.dtype, g.dtype)]}"
    err = getattr(_sweep_lib(), fn)(A.data_ptr(), g.data_ptr(), out.data_ptr(), n, bt,
                                    int(reverse), plan.cluster, _stream(g))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err} (plan {plan})")
    LAUNCHES["btd_sweep"] += 1
    return out


# -- K6T: the transposed block-Thomas sweep ------------------------------------

SWEEP_T_THREADS = 512  # threads a K6T CTA (csrc/btd.cu: TGeometry)


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
    cluster of K6's size; the plain :func:`btd_sweep_t_reference` on the
    CPU).  The dtype pairs of :func:`btd_sweep`."""
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
    n, bt = g.shape
    if bt not in SWEEP_WIDTHS:
        raise ValueError(f"btd_sweep_t: kernel built for row blocks {SWEEP_WIDTHS},"
                         f" got {bt}")
    out = torch.empty_like(g)
    fn = f"vf_btd_sweep_t_{suffix}"
    err = getattr(_sweep_lib(), fn)(A.data_ptr(), g.data_ptr(), out.data_ptr(), n, bt,
                                    int(reverse), SWEEP_CLUSTER[A.dtype], _stream(g))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")
    LAUNCHES["btd_sweep_t"] += 1
    return out
