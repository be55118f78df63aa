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

A plan stacked over S shards (:func:`to_device_stacked`, the per-shard
plans of ``parallel.ddstep``, whose shape metadata agree) takes each of
these with a leading shard axis: :func:`banded_gather_t` and
:func:`banded_scatter_t`, the counterparts of the JAX package's traced-plan
variants (``vf_fem_tpu/fem/banded.py:445, 470``), run K1 and K2 on all
shards in one launch each, the shard in the grid.

``delta_g`` (gather offsets) duplicates a real cell of the group into the
padding slots, so padded cells see finite geometry; ``delta_s`` (scatter
offsets) marks those slots ``w`` so they never contribute.

The TPU built the gather as a one-hot matmul because it has no gather;
on the card each op is a CUDA kernel (``csrc/banded.cu``), replacing
``vf_fem_tpu/fem/banded.py:_gather_kernel`` (K1) and ``:_scatter_kernel``
(K2).  Both stage their input in shared memory first: the gather, one CTA
per (group, chunk of channels), stages the group's window of F; the
scatter, one CTA per (tile of output rows, channel), stages the locals of
every group that adds into its tile and sums a host-built CSR transpose
of the offsets, so it is deterministic and atomic-free.

Each pattern carries its kernels' argument structs, built once in
:func:`to_device` and living as long as the plan, so a launch passes the
struct and a few sizes and reads the raw stream handle.

:func:`banded_gather` and :func:`banded_scatter` dispatch on the tensor's
device: on a CUDA tensor they launch the kernel (or raise); on a CPU
tensor they run the plain PyTorch versions
(:func:`banded_gather_reference`, :func:`banded_scatter_reference`).  Each
is a ``torch.autograd.Function`` whose backward is the other op and whose
tangent (forward mode, ``torch.autograd.forward_ad`` or ``torch.func.jvp``)
is the same op on the tangent.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .. import cuda_build

__all__ = [
    "BandedPlan",
    "DevicePlan",
    "LAUNCHES",
    "LAUNCHES_T",
    "SCATTER_TILE",
    "channels_per_cta",
    "plan_banded",
    "banded_gather",
    "banded_gather_t",
    "banded_scatter",
    "banded_scatter_t",
    "banded_gather_reference",
    "banded_scatter_reference",
    "scatter_order_bound",
    "shard_view",
    "to_device",
    "to_device_stacked",
]

# Kernel launches since the last reset, by kernel; counted where the
# kernel is launched and nowhere else (on a stacked plan in ``LAUNCHES_T``).
LAUNCHES = {"gather": 0, "scatter": 0}
LAUNCHES_T = {"gather_t": 0, "scatter_t": 0}

SCATTER_TILE = 256  # output rows per CTA of the scatter kernel


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
    n_real: int = None,
    w_force: int = None,
    nvert_pad_min: int = None,
) -> BandedPlan:
    """Chunk cells into groups of ``gc`` and compute their vertex windows.

    Windows start at multiples of 128 and have a width that is a multiple
    of 128, as in the JAX package (its TPU lane width), so the two packages
    build identical plans.  Raises ``ValueError`` if the realized window
    exceeds ``max_window`` (the mesh is not bandwidth-ordered).

    ``n_real`` marks ``cells[n_real:]`` as duplicates whose scatter slots
    are masked (0 masks every slot); ``w_force`` and ``nvert_pad_min`` force
    a common window width and padded vertex count: the per-shard plans of
    ``parallel.ddstep`` agree in shape this way, as in the JAX package.
    """
    if gc % 128:
        raise ValueError(f"gc must be a multiple of 128, got {gc}")
    cells = np.asarray(cells)
    nc, nv = cells.shape
    if n_real is None:
        n_real = nc
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
    if w_force is not None:
        if w_force < w or w_force % 128:
            raise ValueError(f"w_force {w_force}: a multiple of 128 >= {w} expected")
        w = w_force

    delta_g = np.transpose(grouped - base[:, None, None], (0, 2, 1)).astype(
        np.int32
    )  # (ngroups, nv, gc) vertex-slot-major
    delta_s = delta_g.copy()
    pad_slots = np.arange(ngroups * gc).reshape(ngroups, gc) >= n_real
    delta_s[np.broadcast_to(pad_slots[:, None, :], delta_s.shape)] = w
    nvert_pad = int(base.max()) + w
    if nvert_pad_min is not None:
        nvert_pad = max(nvert_pad, int(nvert_pad_min))
    return BandedPlan(
        ngroups=ngroups,
        gc=gc,
        nv=nv,
        w=w,
        nvert_pad=nvert_pad,
        ncells=nc,
        base=base.astype(np.int32),
        delta_g=delta_g,
        delta_s=delta_s,
        cells_pad=cells_pad,
    )


class _Pattern(NamedTuple):
    """One offset pattern (gather or scatter offsets) on the device, with
    the arrays and argument structs of the kernels that use it (of a
    stacked plan: each array with a leading shard axis, but ``idx`` and
    ``lidx``, the shards' entries one after another, which ``ptr`` points
    into)."""

    delta: torch.Tensor  # (ngroups, nv, gc) int32
    ptr: torch.Tensor  # (nvert_pad + 1,) int32 CSR row pointers
    idx: torch.Tensor  # (nnz,) int32 entries v * ncpad + cell
    lidx: torch.Tensor  # (nnz,) int32 entries as offsets into a tile's slab
    glo: torch.Tensor  # (ntiles,) int32 first group each scatter tile stages
    ngt: torch.Tensor  # (ntiles,) int32 groups each scatter tile stages
    max_ngt: int
    gather_args: ctypes.Structure  # ``GatherArgs`` of csrc/banded.cu
    scatter_args: ctypes.Structure  # ``ScatterArgs`` of csrc/banded.cu


class DevicePlan(NamedTuple):
    """A :class:`BandedPlan` moved to a device, with the CSR transposes the
    scatter kernel sums over; or S such plans stacked (``base`` (S,
    ngroups), :func:`to_device_stacked`)."""

    ngroups: int
    gc: int
    nv: int
    w: int
    nvert_pad: int
    lead: tuple  # the shard axis of every tensor it takes: (S,) stacked, () single
    base: torch.Tensor  # lead + (ngroups,) int32
    g: _Pattern  # gather offsets (the gather, and the gather's VJP)
    s: _Pattern  # scatter offsets (the scatter, and the scatter's VJP)

    @property
    def ncpad(self) -> int:
        return self.ngroups * self.gc

    @property
    def shards(self) -> int:
        """S of a stacked plan, 1 of a single one."""
        return self.lead[0] if self.lead else 1


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


def _scatter_tiles(plan: BandedPlan, ptr: np.ndarray, idx: np.ndarray):
    """For each tile of ``SCATTER_TILE`` output rows, the first group whose
    entries add into it and the number of groups from there to the last
    (``glo``, ``ngt``; 0 and 0 for a tile nothing adds into), and each CSR
    entry ``v * ncpad + g * gc + j`` as its offset ``(gi * nv + v) * gc +
    j`` into its tile's staged slab, ``gi = g - glo``."""
    ncpad = plan.ngroups * plan.gc
    ntiles = -(-plan.nvert_pad // SCATTER_TILE)
    idx = idx.astype(np.int64)
    v, cell = idx // ncpad, idx % ncpad
    g, j = cell // plan.gc, cell % plan.gc
    tile = np.repeat(np.arange(plan.nvert_pad), np.diff(ptr)) // SCATTER_TILE
    glo = np.full(ntiles, ncpad, dtype=np.int64)
    ghi = np.zeros(ntiles, dtype=np.int64)
    np.minimum.at(glo, tile, g)
    np.maximum.at(ghi, tile, g + 1)
    glo = np.minimum(glo, ghi)
    lidx = ((g - glo[tile]) * plan.nv + v) * plan.gc + j
    return glo, ghi - glo, lidx


def to_device(plan: BandedPlan, device) -> DevicePlan:
    """One plan on the device: the stacked plan of ``[plan]`` without its
    shard axis (views of the same memory, so the kernels' argument structs
    stay valid)."""
    st = to_device_stacked([plan], device)

    def first(pat):
        return pat._replace(delta=pat.delta[0], ptr=pat.ptr[0], glo=pat.glo[0],
                            ngt=pat.ngt[0])

    return st._replace(lead=(), base=st.base[0], g=first(st.g), s=first(st.s))


def to_device_stacked(plans, device) -> DevicePlan:
    """S per-shard plans of equal shape metadata (``ngroups``, ``gc``,
    ``nv``, ``w``, ``nvert_pad``) as one stacked :class:`DevicePlan`: each
    shard's CSR transposes built on the host, concatenated, its row
    pointers offset by the entries of the shards before it."""
    p0 = plans[0]
    meta = (p0.ngroups, p0.gc, p0.nv, p0.w, p0.nvert_pad)
    for p in plans:
        if (p.ngroups, p.gc, p.nv, p.w, p.nvert_pad) != meta:
            raise ValueError(f"to_device_stacked: shard plans differ in shape"
                             f" ({(p.ngroups, p.gc, p.nv, p.w, p.nvert_pad)} vs {meta})")

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    base = i32(np.stack([p.base for p in plans]))

    def pattern(which):
        parts = {k: [] for k in ("delta", "ptr", "idx", "lidx", "glo", "ngt")}
        nnz = 0
        for p in plans:
            delta = getattr(p, which)
            ptr, idx = _csr_transpose(p, delta)
            glo, ngt, lidx = _scatter_tiles(p, ptr, idx)
            for k, v in zip(parts, (delta, ptr.astype(np.int64) + nnz, idx, lidx,
                                    glo, ngt)):
                parts[k].append(v)
            nnz += idx.shape[0]
        # the CSR entries: the shards' one after another
        t = {k: i32(np.concatenate(v) if k in ("idx", "lidx") else np.stack(v))
             for k, v in parts.items()}
        gargs = _GatherArgs(base.data_ptr(), t["delta"].data_ptr(), p0.nv,
                            p0.ngroups, p0.gc, p0.w)
        sargs = _ScatterArgs(t["ptr"].data_ptr(), t["lidx"].data_ptr(),
                             t["glo"].data_ptr(), t["ngt"].data_ptr(), p0.nv,
                             p0.gc, p0.ngroups * p0.gc, SCATTER_TILE,
                             p0.nvert_pad + 1, t["glo"].shape[-1])
        # the structs hold raw pointers: keep their tensors alive with them
        gargs.tensors = (base, t["delta"])
        sargs.tensors = tuple(t.values())
        max_ngt = max(int(n.max(initial=0)) for n in parts["ngt"])
        return _Pattern(**t, max_ngt=max_ngt, gather_args=gargs, scatter_args=sargs)

    return DevicePlan(
        ngroups=p0.ngroups, gc=p0.gc, nv=p0.nv, w=p0.w,
        nvert_pad=p0.nvert_pad, lead=(len(plans),), base=base,
        g=pattern("delta_g"), s=pattern("delta_s"),
    )


def shard_view(plan: DevicePlan, s: int) -> DevicePlan:
    """Shard ``s`` of a stacked plan as a single plan for the plain
    versions (its offsets and row pointers; no kernel arguments)."""
    def view(pat):
        return _Pattern(pat.delta[s], pat.ptr[s], *(None,) * 4, pat.max_ngt,
                        None, None)

    return plan._replace(lead=(), base=plan.base[s], g=view(plan.g), s=view(plan.s))


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


def _shards(plan: DevicePlan, pattern: _Pattern):
    """Each shard of a stacked plan as a single plan, and the name of
    ``pattern`` in it."""
    which = "g" if pattern is plan.g else "s"
    return [(v, getattr(v, which))
            for v in (shard_view(plan, k) for k in range(plan.shards))]


def banded_gather_t_reference(plan: DevicePlan, F: torch.Tensor,
                              pattern: _Pattern) -> torch.Tensor:
    """:func:`banded_gather_reference` on each shard of a stacked plan:
    F (S, C, nF) -> (S, nv, C, ngroups*gc)."""
    return torch.stack([banded_gather_reference(v, x, pat)
                        for (v, pat), x in zip(_shards(plan, pattern), F)])


def banded_scatter_t_reference(plan: DevicePlan, loc: torch.Tensor,
                               n_rows: int, pattern: _Pattern) -> torch.Tensor:
    """:func:`banded_scatter_reference` on each shard of a stacked plan:
    loc (S, nv, C, ngroups*gc) -> (S, C, n_rows)."""
    return torch.stack([banded_scatter_reference(v, x, n_rows, pat)
                        for (v, pat), x in zip(_shards(plan, pattern), loc)])


def scatter_order_bound(
    plan: DevicePlan, loc: torch.Tensor, n_rows: int, pattern: _Pattern
) -> torch.Tensor:
    """Per-entry bound (C, n_rows) on the difference between two summation
    orders of the same scatter: ``2 (n-1) u sum|x|`` for an output summing
    ``n`` terms ``x`` in a dtype of unit roundoff ``u`` (the classic bound
    of recursive summation, for each order).  Of a stacked plan: (S, C,
    n_rows), shard by shard."""
    if plan.lead:
        return torch.stack([scatter_order_bound(v, x, n_rows, pat)
                            for (v, pat), x in zip(_shards(plan, pattern), loc)])
    u = torch.finfo(loc.dtype).eps / 2
    abs_sum = banded_scatter_reference(plan, loc.abs(), n_rows, pattern)
    n = (pattern.ptr[1:] - pattern.ptr[:-1])[:n_rows].to(loc.dtype)
    return 2 * torch.clamp(n - 1, min=0) * u * abs_sum


# -- CUDA kernels -------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    **{f"vf_banded_gather_{t}": [_P, _P, _P, _I, _I, _I, _I, _P] for t in ("f32", "f64")},
    **{f"vf_banded_scatter_{t}": [_P, _P, _P, _I, _I, _I, _I, _P] for t in ("f32", "f64")},
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_SMS = 132  # the H100's streaming multiprocessors
_SMEM = 227 * 1024  # shared memory a CTA may have (csrc/banded.cu kMaxSmem)


class _GatherArgs(ctypes.Structure):
    """``GatherArgs`` of csrc/banded.cu."""

    _fields_ = [("base", _P), ("delta", _P), ("nv", _I), ("ngroups", _I),
                ("gc", _I), ("w", _I)]


class _ScatterArgs(ctypes.Structure):
    """``ScatterArgs`` of csrc/banded.cu."""

    _fields_ = [("ptr", _P), ("lidx", _P), ("glo", _P), ("ngt", _P),
                ("nv", _I), ("gc", _I), ("ncpad", _I), ("tile", _I),
                ("nptr", _I), ("ntiles", _I)]


def channels_per_cta(C: int, ngroups: int, chan_bytes: int) -> int:
    """Channels each CTA of a K1 launch stages (one CTA per group and chunk
    of channels, ``chan_bytes`` staged a channel): a group's channels are
    split into just enough chunks for the CTAs to cover the card's
    ``_SMS`` SMs, and into more where a CTA's shared memory (a window and
    an 8-byte mbarrier a channel) would not hold them."""
    cpb = -(-C // min(C, -(-_SMS // ngroups)))
    return max(1, min(cpb, (_SMEM - 16) // (chan_bytes + 8)))


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


def _launch(op: str, x: torch.Tensor, out: torch.Tensor, args, plan: DevicePlan,
            *sizes):
    if not x.is_contiguous():
        raise ValueError(f"banded {op}: input must be contiguous")
    lib = cuda_build.load("banded.cu", _SIGNATURES)
    err = getattr(lib, f"vf_banded_{op}_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), out.data_ptr(), ctypes.addressof(args), *sizes,
        plan.shards, cuda_build.raw_stream(x))
    if err != 0:
        raise RuntimeError(f"banded {op} launch failed: cudaError_t {err}")
    if plan.lead:
        LAUNCHES_T[op + "_t"] += 1
    else:
        LAUNCHES[op] += 1
    return out


def _gather(plan: DevicePlan, F: torch.Tensor, pattern: _Pattern):
    lead = plan.lead
    _check(plan, F, 2 + len(lead), "banded gather")
    if tuple(F.shape[:len(lead)]) != lead:
        raise ValueError(f"banded gather: fields {tuple(F.shape)} for {lead} shards")
    C, n_cols = F.shape[-2:]
    if n_cols > plan.nvert_pad:
        raise ValueError(
            f"banded gather: {n_cols} columns > nvert_pad {plan.nvert_pad}"
        )
    if F.device.type == "cpu":
        if lead:
            return banded_gather_t_reference(plan, F, pattern)
        return banded_gather_reference(plan, F, pattern)
    out = torch.empty(lead + (plan.nv, C, plan.ncpad), dtype=F.dtype, device=F.device)
    cpb = channels_per_cta(C, plan.ngroups * plan.shards, plan.w * F.element_size())
    return _launch("gather", F, out, pattern.gather_args, plan, C, n_cols, cpb)


def _scatter(plan: DevicePlan, loc: torch.Tensor, n_rows: int,
             pattern: _Pattern):
    lead = plan.lead
    _check(plan, loc, 3 + len(lead), "banded scatter")
    if (tuple(loc.shape[:len(lead)]) != lead or loc.shape[-3] != plan.nv
            or loc.shape[-1] != plan.ncpad):
        raise ValueError(
            f"banded scatter: locals of shape {tuple(loc.shape)}, plan expects"
            f" {lead + (plan.nv, 'C', plan.ncpad)}"
        )
    if n_rows > plan.nvert_pad:
        raise ValueError(
            f"banded scatter: {n_rows} rows > nvert_pad {plan.nvert_pad}"
        )
    if loc.device.type == "cpu":
        if lead:
            return banded_scatter_t_reference(plan, loc, n_rows, pattern)
        return banded_scatter_reference(plan, loc, n_rows, pattern)
    if loc.data_ptr() % 16:
        raise ValueError("banded scatter: locals must be 16-byte aligned")
    slab = pattern.max_ngt * plan.nv * plan.gc * loc.element_size()
    if slab + 16 > _SMEM:
        raise ValueError(
            f"banded scatter: a tile of {SCATTER_TILE} rows adds from"
            f" {pattern.max_ngt} groups, {slab} bytes, more than a CTA holds"
            f" ({_SMEM}); renumber the mesh (reorder='rcm')"
        )
    C = loc.shape[-2]
    out = torch.empty(lead + (C, n_rows), dtype=loc.dtype, device=loc.device)
    return _launch("scatter", loc, out, pattern.scatter_args, plan, C, n_rows,
                   pattern.max_ngt)


class _BandedGather(torch.autograd.Function):
    """K1 with K2 as its backward (the scatter with the gather offsets) and
    K1 again as its tangent: the gather is linear."""

    @staticmethod
    def forward(F, plan):
        return _gather(plan, F, plan.g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        F, plan = inputs
        ctx.plan = plan
        ctx.n_cols = F.shape[1]

    @staticmethod
    def backward(ctx, ct):
        # transpose of the gather pattern: padded slots read real cells, so
        # their cotangents flow back -- scatter with the gather offsets
        return _scatter(ctx.plan, ct.contiguous(), ctx.n_cols, ctx.plan.g), None

    @staticmethod
    def jvp(ctx, F_dot, _):
        # through apply: under torch.func the rule sees the transform's
        # tensors, which the Function hands to the kernel unwrapped
        return _BandedGather.apply(F_dot.contiguous(), ctx.plan)

    @staticmethod
    def vmap(info, in_dims, F, plan):
        # a batch of fields is more channels: one launch for all of them
        if in_dims[0] is None:
            return _BandedGather.apply(F, plan), None
        F = F.movedim(in_dims[0], 0)
        B, C, n = F.shape
        out = _BandedGather.apply(F.reshape(B * C, n).contiguous(), plan)
        return out.reshape(out.shape[0], B, C, out.shape[2]), 1


class _BandedScatter(torch.autograd.Function):
    """K2 with K1 as its backward (the gather with the scatter offsets) and
    K2 again as its tangent: the scatter is linear."""

    @staticmethod
    def forward(loc, plan, n_rows):
        return _scatter(plan, loc, n_rows, plan.s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.plan, ctx.n_rows = inputs

    @staticmethod
    def backward(ctx, ct):
        # transpose of the scatter = gather with the scatter offsets
        # (padding slots get zero cotangents)
        return _gather(ctx.plan, ct.contiguous(), ctx.plan.s), None, None

    @staticmethod
    def jvp(ctx, loc_dot, *_):
        return _BandedScatter.apply(loc_dot.contiguous(), ctx.plan, ctx.n_rows)

    @staticmethod
    def vmap(info, in_dims, loc, plan, n_rows):
        # a batch of locals is more channels: one launch for all of them
        if in_dims[0] is None:
            return _BandedScatter.apply(loc, plan, n_rows), None
        loc = loc.movedim(in_dims[0], 1)
        nv, B, C, w = loc.shape
        out = _BandedScatter.apply(loc.reshape(nv, B * C, w).contiguous(), plan, n_rows)
        return out.reshape(B, C, n_rows), 0


def _differentiated(x: torch.Tensor) -> bool:
    """Whether ``x`` is being differentiated: it requires grad with grad
    mode on (autograd, ``torch.func.grad``/``vjp``), or it carries a
    forward-mode tangent (``torch.autograd.forward_ad``,
    ``torch.func.jvp``/``jacfwd``).  Public queries only, the cheaper
    first."""
    if torch.is_grad_enabled() and x.requires_grad:
        return True
    return fwAD.unpack_dual(x).tangent is not None


def _through_function(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` goes through its ``autograd.Function``: ``x``
    is being differentiated (:func:`_differentiated`) or is a
    ``torch.func`` transform's tensor, such as a batch under ``vmap``
    (whose rule makes the batch more channels of one launch).  The
    transform's test comes first: a batched tensor has no rule for
    ``unpack_dual`` (a vmapped residual in a tangent rule)."""
    return torch._C._functorch.is_functorch_wrapped_tensor(x) or _differentiated(x)


def banded_gather(plan: DevicePlan, F: torch.Tensor) -> torch.Tensor:
    """Gather per-cell locals (nv, C, ngroups*gc) from stacked vertex
    fields ``F`` (C, n_vertices).  Reverse mode differentiates to the
    banded scatter with the gather offsets, forward mode to the gather of
    the tangent; where nothing is differentiated the call skips the
    autograd wrapper, unless ``F`` is a batch under ``torch.func.vmap``."""
    if _through_function(F):
        return _BandedGather.apply(F, plan)
    return _gather(plan, F, plan.g)


def banded_scatter(plan: DevicePlan, loc: torch.Tensor, n_rows: int):
    """Scatter-add per-cell nodal values ``loc`` (nv, C, ngroups*gc) into
    (C, n_rows); padding slots are dropped.  Reverse mode differentiates to
    the banded gather with the scatter offsets, forward mode to the scatter
    of the tangent; where nothing is differentiated the call skips the
    autograd wrapper, unless ``loc`` is a batch under ``torch.func.vmap``."""
    if _through_function(loc):
        return _BandedScatter.apply(loc, plan, n_rows)
    return _scatter(plan, loc, n_rows, plan.s)


class _BandedGatherT(torch.autograd.Function):
    """K1 on a stacked plan with K2 on it as its backward (the scatter with
    the gather offsets), as ``banded_gather_t``'s custom VJP."""

    @staticmethod
    def forward(F, plan):
        return _gather(plan, F, plan.g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        F, plan = inputs
        ctx.plan = plan
        ctx.n_cols = F.shape[-1]

    @staticmethod
    def backward(ctx, ct):
        return _scatter(ctx.plan, ct.contiguous(), ctx.n_cols, ctx.plan.g), None


class _BandedScatterT(torch.autograd.Function):
    """K2 on a stacked plan with K1 on it as its backward (the gather with
    the scatter offsets), as ``banded_scatter_t``'s custom VJP."""

    @staticmethod
    def forward(loc, plan, n_rows):
        return _scatter(plan, loc, n_rows, plan.s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.plan, ctx.n_rows = inputs

    @staticmethod
    def backward(ctx, ct):
        return _gather(ctx.plan, ct.contiguous(), ctx.plan.s), None, None


def banded_gather_t(plan: DevicePlan, F: torch.Tensor) -> torch.Tensor:
    """:func:`banded_gather` on every shard of a stacked plan: F (S, C,
    n_vertices) -> (S, nv, C, ngroups*gc), one launch of K1 (the JAX
    package's ``banded_gather_t``).  Reverse mode differentiates to
    :func:`banded_scatter_t` with the gather offsets."""
    if not plan.lead:
        raise ValueError("banded_gather_t: a stacked plan expected")
    if torch.is_grad_enabled() and F.requires_grad:
        return _BandedGatherT.apply(F, plan)
    return _gather(plan, F, plan.g)


def banded_scatter_t(plan: DevicePlan, loc: torch.Tensor, n_rows: int):
    """:func:`banded_scatter` on every shard of a stacked plan: loc (S, nv,
    C, ngroups*gc) -> (S, C, n_rows), one launch of K2 (the JAX package's
    ``banded_scatter_t``).  Reverse mode differentiates to
    :func:`banded_gather_t` with the scatter offsets."""
    if not plan.lead:
        raise ValueError("banded_scatter_t: a stacked plan expected")
    if torch.is_grad_enabled() and loc.requires_grad:
        return _BandedScatterT.apply(loc, plan, n_rows)
    return _scatter(plan, loc, n_rows, plan.s)
