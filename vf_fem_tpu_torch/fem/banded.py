"""
Banded gather/scatter of the residual cell pass: kernels K1 and K2.

Counterpart of ``vf_fem_tpu.fem.banded``.  The plan is the JAX package's
(same numpy construction, identical arrays): cells are chunked into groups
of ``gc``, and each group touches a contiguous vertex window
``[base[g], base[g] + w)``.  Layouts are channels-major (SoA, cell index
last):

- fields  F: (C, n_vertices) -- all cg1 channels stacked
- locals:    (nv, C, ngroups*gc)
- assembled: (C, n_rows)

``delta_g`` (gather offsets) duplicates a real cell of the group into the
padding slots, so padded cells see finite geometry; ``delta_s`` (scatter
offsets) marks those slots ``w`` so they never contribute.

The TPU built the gather as a one-hot matmul because it has no gather;
on the card each op is a direct indexed CUDA kernel (``csrc/banded.cu``),
replacing ``vf_fem_tpu/fem/banded.py:_gather_kernel`` (K1) and
``:_scatter_kernel`` (K2).  The scatter sums over a host-built CSR
transpose of the offsets, so it is deterministic and atomic-free.

:func:`banded_gather` and :func:`banded_scatter` dispatch on the tensor's
device: on a CUDA tensor they launch the kernel (or raise); on a CPU
tensor they run the plain PyTorch versions
(:func:`banded_gather_reference`, :func:`banded_scatter_reference`).  Each
is a ``torch.autograd.Function`` whose backward is the other op.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build

__all__ = [
    "BandedPlan",
    "DevicePlan",
    "LAUNCHES",
    "plan_banded",
    "banded_gather",
    "banded_scatter",
    "banded_gather_reference",
    "banded_scatter_reference",
    "scatter_order_bound",
    "to_device",
]

# Kernel launches since the last reset, by kernel; counted where the
# kernel is launched and nowhere else.
LAUNCHES = {"gather": 0, "scatter": 0}


class BandedPlan(NamedTuple):
    """Static (host-built) plan; the arrays of ``vf_fem_tpu.fem.banded``."""

    ngroups: int
    gc: int  # cells per group
    nv: int  # vertices per cell
    w: int  # vertex window width
    nvert_pad: int  # padded vertex count (>= max(base) + w)
    ncells: int
    base: np.ndarray  # (ngroups,) int32 window starts
    delta_g: np.ndarray  # (ngroups, nv, gc) int32 gather offsets
    delta_s: np.ndarray  # (ngroups, nv, gc) int32 scatter offsets
    cells_pad: np.ndarray  # (ngroups*gc, nv) cells with padding rows


def plan_banded(
    cells: np.ndarray,
    n_vertices: int,
    gc: int = 128,
    max_window: int = 2048,
) -> BandedPlan:
    """Chunk cells into groups of ``gc`` and compute their vertex windows.

    Windows start at multiples of 128 and have a width that is a multiple
    of 128, as in the JAX package (its TPU lane width), so the two packages
    build identical plans.  Raises ``ValueError`` if the realized window
    exceeds ``max_window`` (the mesh is not bandwidth-ordered).
    """
    if gc % 128:
        raise ValueError(f"gc must be a multiple of 128, got {gc}")
    cells = np.asarray(cells)
    nc, nv = cells.shape
    ngroups = -(-nc // gc)
    npad = ngroups * gc - nc
    # padding duplicates the last real cell (finite geometry, masked in
    # the scatter offsets)
    cells_pad = np.concatenate(
        [cells, np.broadcast_to(cells[-1:], (npad, nv))], axis=0
    )
    grouped = cells_pad.reshape(ngroups, gc, nv)

    gmin = grouped.reshape(ngroups, -1).min(axis=1)
    gmax = grouped.reshape(ngroups, -1).max(axis=1)
    base = (gmin // 128) * 128
    span = int((gmax - base + 1).max())
    w = -(-span // 128) * 128
    if w > max_window:
        raise ValueError(
            f"banded-assembly window {w} > {max_window}: the mesh is not"
            " bandwidth-ordered; renumber it (reverse Cuthill-McKee, cells"
            " sorted by min vertex) before building the model"
        )

    delta_g = np.transpose(grouped - base[:, None, None], (0, 2, 1)).astype(
        np.int32
    )  # (ngroups, nv, gc) vertex-slot-major
    delta_s = delta_g.copy()
    pad_slots = np.arange(ngroups * gc).reshape(ngroups, gc) >= nc
    delta_s[np.broadcast_to(pad_slots[:, None, :], delta_s.shape)] = w
    return BandedPlan(
        ngroups=ngroups,
        gc=gc,
        nv=nv,
        w=w,
        nvert_pad=int(base.max()) + w,
        ncells=nc,
        base=base.astype(np.int32),
        delta_g=delta_g,
        delta_s=delta_s,
        cells_pad=cells_pad,
    )


class _Pattern(NamedTuple):
    """One offset pattern (gather or scatter offsets) on the device."""

    delta: torch.Tensor  # (ngroups, nv, gc) int32
    ptr: torch.Tensor  # (nvert_pad + 1,) int32 CSR row pointers
    idx: torch.Tensor  # (nnz,) int32 entries v * ncpad + cell


class DevicePlan(NamedTuple):
    """A :class:`BandedPlan` moved to a device, with the CSR transposes the
    scatter kernel sums over."""

    ngroups: int
    gc: int
    nv: int
    w: int
    nvert_pad: int
    base: torch.Tensor  # (ngroups,) int32
    g: _Pattern  # gather offsets (the gather, and the gather's VJP)
    s: _Pattern  # scatter offsets (the scatter, and the scatter's VJP)

    @property
    def ncpad(self) -> int:
        return self.ngroups * self.gc


def _csr_transpose(plan: BandedPlan, delta: np.ndarray):
    """For every padded vertex, the (slot, cell) entries that add into it,
    as ``v * ncpad + cell``, in (v, group, cell) order -- the order in
    which :func:`banded_scatter_reference` adds them on the CPU.  Entries
    with ``delta == w`` are dropped."""
    ng, nv, gc = delta.shape
    ncpad = ng * gc
    target = plan.base.astype(np.int64)[:, None, None] + delta
    src = (
        np.arange(nv)[None, :, None] * ncpad
        + np.arange(ng)[:, None, None] * gc
        + np.arange(gc)[None, None, :]
    )
    keep = (delta != plan.w).transpose(1, 0, 2).reshape(-1)
    target = target.transpose(1, 0, 2).reshape(-1)[keep]
    src = np.broadcast_to(src, delta.shape).transpose(1, 0, 2).reshape(-1)[keep]
    order = np.argsort(target, kind="stable")
    ptr = np.zeros(plan.nvert_pad + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(np.bincount(target, minlength=plan.nvert_pad))
    return ptr.astype(np.int32), src[order].astype(np.int32)


def to_device(plan: BandedPlan, device) -> DevicePlan:
    def i32(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.int32), device=device
        )

    def pattern(delta):
        ptr, idx = _csr_transpose(plan, delta)
        return _Pattern(delta=i32(delta), ptr=i32(ptr), idx=i32(idx))

    return DevicePlan(
        ngroups=plan.ngroups, gc=plan.gc, nv=plan.nv, w=plan.w,
        nvert_pad=plan.nvert_pad, base=i32(plan.base),
        g=pattern(plan.delta_g), s=pattern(plan.delta_s),
    )


# -- Plain PyTorch versions ---------------------------------------------------


def banded_gather_reference(
    plan: DevicePlan, F: torch.Tensor, pattern: _Pattern
) -> torch.Tensor:
    """Masked indexing: F (C, nF) -> (nv, C, ngroups*gc); entries with
    ``delta == w`` read zero, as do columns beyond F's (zero padding)."""
    C = F.shape[0]
    Fp = F.new_zeros((C, plan.nvert_pad))
    Fp[:, : F.shape[1]] = F
    delta = pattern.delta.long()
    idx = (plan.base.long()[:, None, None] + delta).clamp(max=plan.nvert_pad - 1)
    out = Fp[:, idx]  # (C, ngroups, nv, gc)
    out = torch.where((delta < plan.w)[None], out, 0.0)
    return out.permute(2, 0, 1, 3).reshape(plan.nv, C, plan.ncpad)


def banded_scatter_reference(
    plan: DevicePlan, loc: torch.Tensor, n_rows: int, pattern: _Pattern
) -> torch.Tensor:
    """``index_add_`` into ``nvert_pad + 1`` bins, the overflow bin (padding
    slots, ``delta == w``) dropped: loc (nv, C, ngroups*gc) -> (C, n_rows)."""
    nv, C = plan.nv, loc.shape[1]
    delta = pattern.delta.long()
    idx = torch.where(
        delta == plan.w, plan.nvert_pad, plan.base.long()[:, None, None] + delta
    )
    flat_idx = idx.permute(1, 0, 2).reshape(-1)  # (v, group, cell) order
    vals = loc.reshape(nv, C, plan.ngroups, plan.gc).movedim(1, -1)
    out = loc.new_zeros((plan.nvert_pad + 1, C))
    out.index_add_(0, flat_idx, vals.reshape(-1, C))
    return out[:n_rows].T


def scatter_order_bound(
    plan: DevicePlan, loc: torch.Tensor, n_rows: int, pattern: _Pattern
) -> torch.Tensor:
    """Per-entry bound (C, n_rows) on the difference between two summation
    orders of the same scatter: ``2 (n-1) u sum|x|`` for an output summing
    ``n`` terms ``x`` in a dtype of unit roundoff ``u`` (the classic bound
    of recursive summation, for each order)."""
    u = torch.finfo(loc.dtype).eps / 2
    abs_sum = banded_scatter_reference(plan, loc.abs(), n_rows, pattern)
    n = (pattern.ptr[1:] - pattern.ptr[:-1])[:n_rows].to(loc.dtype)
    return 2 * torch.clamp(n - 1, min=0) * u * abs_sum


# -- CUDA kernels -------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    **{
        f"vf_banded_gather_{t}": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        for t in ("f32", "f64")
    },
    **{
        f"vf_banded_scatter_{t}": [_P, _P, _P, _P, _I, _I, _I, _P]
        for t in ("f32", "f64")
    },
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return cuda_build.load("banded.cu", _SIGNATURES)


def _check(plan: DevicePlan, x: torch.Tensor, ndim: int, what: str):
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what}: float32 or float64 expected, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{what}: {ndim}-D tensor expected, got {tuple(x.shape)}")
    if x.device != plan.base.device:
        raise ValueError(
            f"{what}: tensor on {x.device}, plan on {plan.base.device}"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _gather(plan: DevicePlan, F: torch.Tensor, pattern: _Pattern):
    _check(plan, F, 2, "banded gather")
    if F.shape[1] > plan.nvert_pad:
        raise ValueError(
            f"banded gather: {F.shape[1]} columns > nvert_pad {plan.nvert_pad}"
        )
    if F.device.type == "cpu":
        return banded_gather_reference(plan, F, pattern)
    if not F.is_contiguous():
        raise ValueError("banded gather: F must be contiguous")
    C = F.shape[0]
    out = torch.empty((plan.nv, C, plan.ncpad), dtype=F.dtype, device=F.device)
    name = f"vf_banded_gather_{_SUFFIX[F.dtype]}"
    err = getattr(_lib(), name)(
        F.data_ptr(), plan.base.data_ptr(), pattern.delta.data_ptr(),
        out.data_ptr(), C, plan.nv, plan.ngroups, plan.gc, plan.w,
        F.shape[1], torch.cuda.current_stream(F.device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES["gather"] += 1
    return out


def _scatter(plan: DevicePlan, loc: torch.Tensor, n_rows: int,
             pattern: _Pattern):
    _check(plan, loc, 3, "banded scatter")
    if loc.shape[0] != plan.nv or loc.shape[2] != plan.ncpad:
        raise ValueError(
            f"banded scatter: locals of shape {tuple(loc.shape)}, plan expects"
            f" ({plan.nv}, C, {plan.ncpad})"
        )
    if n_rows > plan.nvert_pad:
        raise ValueError(
            f"banded scatter: {n_rows} rows > nvert_pad {plan.nvert_pad}"
        )
    if loc.device.type == "cpu":
        return banded_scatter_reference(plan, loc, n_rows, pattern)
    if not loc.is_contiguous():
        raise ValueError("banded scatter: locals must be contiguous")
    C = loc.shape[1]
    out = torch.empty((C, n_rows), dtype=loc.dtype, device=loc.device)
    name = f"vf_banded_scatter_{_SUFFIX[loc.dtype]}"
    err = getattr(_lib(), name)(
        loc.data_ptr(), pattern.ptr.data_ptr(), pattern.idx.data_ptr(),
        out.data_ptr(), C, plan.ncpad, n_rows,
        torch.cuda.current_stream(loc.device).cuda_stream,
    )
    _raise_on(err, name)
    LAUNCHES["scatter"] += 1
    return out


class _BandedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, F, plan):
        ctx.plan = plan
        ctx.n_cols = F.shape[1]
        return _gather(plan, F, plan.g)

    @staticmethod
    def backward(ctx, ct):
        # transpose of the gather pattern: padded slots read real cells, so
        # their cotangents flow back -- scatter with the gather offsets
        return _scatter(ctx.plan, ct.contiguous(), ctx.n_cols, ctx.plan.g), None


class _BandedScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loc, plan, n_rows):
        ctx.plan = plan
        return _scatter(plan, loc, n_rows, plan.s)

    @staticmethod
    def backward(ctx, ct):
        # transpose of the scatter = gather with the scatter offsets
        # (padding slots get zero cotangents)
        return _gather(ctx.plan, ct.contiguous(), ctx.plan.s), None, None


def banded_gather(plan: DevicePlan, F: torch.Tensor) -> torch.Tensor:
    """Gather per-cell locals (nv, C, ngroups*gc) from stacked vertex
    fields ``F`` (C, n_vertices).  Reverse mode differentiates to the
    banded scatter with the gather offsets."""
    return _BandedGather.apply(F, plan)


def banded_scatter(plan: DevicePlan, loc: torch.Tensor, n_rows: int):
    """Scatter-add per-cell nodal values ``loc`` (nv, C, ngroups*gc) into
    (C, n_rows); padding slots are dropped.  Reverse mode differentiates to
    the banded gather with the scatter offsets."""
    return _BandedScatter.apply(loc, plan, n_rows)
