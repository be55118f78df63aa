"""
DOF-sharded explicit FSI time stepping (counterpart of
``vf_fem_tpu.parallel.ddstep``, its forward step on ``ExplicitFSIModel``).

After RCM renumbering the block rows group into ``Bt``-sized super-rows
(``solvers.bsb`` / ``btd``); shard ``s`` owns ``m`` consecutive super-rows,
``ndof_loc = m Bt`` dofs.  Cells belong to the shard of their lowest dof;
a cell's support spills at most ``Bt`` dofs into the next shard, a right
halo of fixed width.  One step:

- assembly: the per-element closures of ``SolidModel`` on each shard's
  cells, reading the shard's dofs and the next shard's halo; the sums
  past ``ndof_loc`` are shipped to the next shard (``shards.spill_add``).
  With ``assembly='banded'`` the cell pass is one launch of K1 and one of
  K2 over all shards (``fem.banded.banded_gather_t`` /
  ``banded_scatter_t`` on per-shard plans stacked by
  :func:`plan_dd_banded`); 'plain' (the default) takes indexed gathers
  and deterministic scatters; 'auto' is 'banded' on CUDA, as the JAX
  package takes it on the TPU, and 'plain' elsewhere.  Where the
  partition cannot take the banded plan, 'banded' (and 'auto' on CUDA)
  raises;
- factors: each shard fills its slab of the block-banded Jacobian,
  equilibrates it with its neighbours' scale halos and factors it with
  SPIKE, one slab a shard (``solvers.spike`` on the stacked slabs: K6
  over slabs in the solves), once a refresh window of
  ``jacobian_refresh_steps`` steps;
- the chord Newton of ``solvers.newton`` on the sharded vector, the
  Newmark update, and the fluid: each shard's surface areas summed over
  the shards and the 1D Bernoulli solve once.

The JAX package runs this as one ``shard_map`` program over S devices.
Here the S shards are stacked on one device: every per-shard array has a
leading axis S, the collectives are tensor operations along it
(:mod:`.shards`), and the element kernels run over shards x cells as one
batch.  It is the same computation, and it runs on the CPU (the plain
versions of the kernels) as on the card.

Gradients through the run (inputs that require grad): the chord Newton
of each step is :class:`_SolveU1DD`, whose backward is the JAX package's
IFT ``custom_vjp`` (``vf_fem_tpu/parallel/ddstep.py:940-1068``): the
sharded residual rebuilt at u1, ``J^T v`` by autograd through it (the
shard collectives, and K1/K2 over the stacked plans through each other),
the adjoint refined with the window's factors as a transposed
preconditioner (the transposed SPIKE solve: K6T over slabs), the norms
summed over the shards, and ``-lam``'s vjp into the state, the pressure,
the properties and the step's Newmark coefficients (so the times get
their gradient).  The values are the no-grad run's bit for bit.

Not ported (``NotImplementedError``, ROADMAP item 22): the implicit and
FSAI models, shape parameters (``prop/umesh``) and ``dp_axis`` batches.
Nor are the TPU's own idioms: the data-derived carry inits, the finite
stagnation sentinels, the DP predicate, the f64 fallback of the banded
kernels.
"""

from __future__ import annotations

import warnings
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import forward as fwd
from ..convert import to_numpy, to_tensors
from ..equations import newmark
from ..fem import assembly, banded
from ..models.transient import (
    ExplicitFSIModel,
    ImplicitFSIModel,
    _contact_traction,
    refined_adjoint,
    solver_params,
)
from ..solvers import btd, spike
from ..solvers.newton import SolveInfo, newton_solve
from ..step_graph import refresh_windows
from . import shards

__all__ = ["DDPlan", "plan_dd", "plan_dd_banded", "DDIntegrator"]

TODO = "ROADMAP item 22"


class DDPlan(NamedTuple):
    """Host-built plan of the sharded step (numpy), the JAX package's."""

    S: int
    b: int
    h: int
    Bt: int
    m: int  # super-rows a slab
    nblk_loc: int
    ndof_loc: int
    ndof: int
    ndof_pad: int
    nvert: int
    dim: int
    n_fl: int
    nv: int
    nld: int
    flat_size: int  # a slab's band with h spill block rows, (nblk_loc+h)*nb*b*b
    # per-shard arrays (leading axis S)
    cells: np.ndarray  # (S, ncm, nv) global vertex ids
    cell_ids: np.ndarray  # (S, ncm) global cell ids (dg0 coefficients)
    cell_dofs_loc: np.ndarray  # (S, ncm, nld) shard-local dof indices
    cell_mask: np.ndarray  # (S, ncm)
    Xe_c: np.ndarray  # (S, ncm, nv, dim) cell vertex coordinates
    fcv: np.ndarray  # (S, nfm, nv) facet-cell vertex ids
    f_ids: np.ndarray  # (S, nfm) facet-cell global cell ids
    facet_dofs_loc: np.ndarray  # (S, nfm, nld)
    facet_mask: np.ndarray  # (S, nfm)
    facet_sel: np.ndarray  # (S, nfm, nv, dimf)
    facet_opp_sel: np.ndarray  # (S, nfm, nv)
    Xe_f: np.ndarray  # (S, nfm, nv, dim)
    bc_mask_loc: np.ndarray  # (S, ndof_loc)
    fill_tgt: np.ndarray  # (S, n_src) int32, dump slot = flat_size
    diag_idx: np.ndarray  # (S, n_diag) int32, dump slot = flat_size
    col_idx: np.ndarray  # (nblk_loc, nb) column-scale block index
    fl_idx: np.ndarray  # (S, nflm) fluid dof owned (dump = n_fl)
    fl_udof: np.ndarray  # (S, nflm) local dof of the y displacement
    fl_y: np.ndarray  # (S, nflm) reference y coordinate
    fl_vert: np.ndarray  # (S, nflm) global surface vertex id
    fl_mask: np.ndarray  # (S, nflm)


def _pad_groups(idx_lists, pad_value_fn, max_len=None):
    """Pad per-shard index lists to equal length; an empty shard gets one
    masked entry from ``pad_value_fn(s, g)``."""
    n = max(max(len(g) for g in idx_lists), 1)
    if max_len is not None:
        n = max(n, max_len)
    out, mask = [], []
    for s, g in enumerate(idx_lists):
        g = list(g)
        msk = [1.0] * len(g)
        while len(g) < n:
            g.append(pad_value_fn(s, g))
            msk.append(0.0)
        out.append(g)
        mask.append(msk)
    return np.asarray(out), np.asarray(mask)


def _check_model(model):
    if isinstance(model, ImplicitFSIModel):
        raise NotImplementedError(f"DD stepping of ImplicitFSIModel: {TODO}")
    if not isinstance(model, ExplicitFSIModel):
        raise NotImplementedError(
            f"DD stepping of {type(model).__name__} (the FSAI model): {TODO}")


def plan_dd(model, n_shards: int) -> DDPlan:
    """Partition an ``ExplicitFSIModel`` over ``n_shards`` DOF slabs."""
    _check_model(model)
    solid = model.solid
    R = solid.residual
    topo = R.topology
    bsbp = solid.bsb_plan()[0]
    b, h, nb = bsbp.b, bsbp.h, bsbp.nb
    ndof, nblk = solid.ndof, bsbp.nblk
    S = int(n_shards)
    n_sup = -(-nblk // h)
    m = -(-n_sup // S)  # >= 1; slabs beyond n_sup are fully masked padding
    if n_sup < S:
        warnings.warn(
            f"plan_dd: the mesh bandwidth (half-band {h} blocks, Bt={h * b})"
            f" leaves only {n_sup} super-rows for {S} shards; {S - n_sup}"
            " slabs will be empty.  RCM-renumber the mesh"
            " (mesh.reorder.rcm_mesh / loader reorder='rcm') for a balanced"
            " partition", RuntimeWarning)
    nblk_loc = m * h
    ndof_loc = nblk_loc * b
    ndof_pad = S * ndof_loc
    Bt = h * b
    dim, nvert = solid.dim, solid.nvert
    cells = np.asarray(R.mesh().cells)
    nc, nv = cells.shape
    nld = nv * dim
    cdofs = solid._elem_dofs[0]
    fcells = topo.facet_cells.cpu().numpy()
    nf = fcells.shape[0] if R.has_facet_pass() else 0
    fdofs = solid._elem_dofs[1] if nf else np.zeros((0, nld), dtype=np.int64)
    Xref = np.asarray(R.mesh().coords)

    bc = np.zeros(ndof_pad, dtype=bool)
    bc[np.asarray(R.bc_dofs)] = True
    bc[ndof:] = True  # global padding rows are identity rows

    def check_and_assign(darr):
        s = darr.min(axis=1) // ndof_loc
        spill = darr.max(axis=1) - s * ndof_loc
        if not (spill < ndof_loc + Bt).all():
            raise ValueError(
                "plan_dd: an element's dof support exceeds one halo width"
                f" (max spill {int(spill.max())} >= slab {ndof_loc} + halo"
                f" {Bt}).  The mesh bandwidth is too large for this slab"
                " size: RCM-renumber the mesh (mesh.reorder.rcm_mesh /"
                " loader reorder='rcm') or reduce n_shards")
        return s

    sc = check_and_assign(cdofs) if nc else np.zeros(0, int)
    sf = check_and_assign(fdofs) if nf else np.zeros(0, int)

    cell_groups = [np.nonzero(sc == s)[0] for s in range(S)]
    facet_groups = [np.nonzero(sf == s)[0] for s in range(S)]
    first = lambda s, g: g[0] if g else 0  # noqa: E731
    cell_ids, cell_mask = _pad_groups(cell_groups, first)
    f_sel_ids, facet_mask = _pad_groups(facet_groups, first)
    nfm = f_sel_ids.shape[1]

    def loc_dofs(ids, darr, s):
        # padding entries may index elements of other slabs: clamp into
        # the valid gather range; they are masked anyway
        return np.clip(darr[ids] - s * ndof_loc, 0, ndof_loc + Bt - 1)

    cell_dofs_loc = np.stack([loc_dofs(cell_ids[s], cdofs, s) for s in range(S)])
    if nf:
        facet_dofs_loc = np.stack([loc_dofs(f_sel_ids[s], fdofs, s)
                                   for s in range(S)])
        fcv = cells[fcells][f_sel_ids]
        facet_sel = topo.facet_sel.cpu().numpy()[f_sel_ids]
        facet_opp_sel = topo.facet_opp_sel.cpu().numpy()[f_sel_ids]
        f_cell_ids = fcells[f_sel_ids]
    else:
        facet_dofs_loc = np.zeros((S, nfm, nld), dtype=np.int64)
        fcv = np.zeros((S, nfm, nv), dtype=cells.dtype)
        facet_sel = np.zeros((S, nfm, nv, dim))
        facet_opp_sel = np.zeros((S, nfm, nv))
        f_cell_ids = np.zeros((S, nfm), dtype=np.int64)
    cells_s = cells[cell_ids]  # (S, ncm, nv)
    bc_mask_loc = bc.reshape(S, ndof_loc).astype(np.float64)

    # banded fill targets: the slab's band plus h spill block rows
    flat_size = (nblk_loc + h) * nb * b * b

    def fill_targets(ids, mask, darr, s):
        d = darr[ids]  # (ne, nld) global dofs
        rows = np.broadcast_to(d[:, :, None], d.shape + (nld,))
        cols = np.broadcast_to(d[:, None, :], d.shape + (nld,))
        blk_r = (rows - s * ndof_loc) // b
        mband = cols // b - rows // b + h
        tgt = ((blk_r * nb + mband) * b + rows % b) * b + cols % b
        drop = bc[rows] | (mask[:, None, None] == 0.0)
        return np.where(drop, flat_size, tgt).reshape(-1)

    fill_tgt = np.stack([
        np.concatenate([
            fill_targets(cell_ids[s], cell_mask[s], cdofs, s),
            fill_targets(f_sel_ids[s], facet_mask[s], fdofs, s) if nf
            else np.zeros(0, dtype=np.int64),
        ]) for s in range(S)
    ]).astype(np.int32)

    # identity diagonal for BC and padding rows; padded entries dump
    diag_lists = []
    for s in range(S):
        r = np.nonzero(bc[s * ndof_loc:(s + 1) * ndof_loc])[0]
        diag_lists.append(list((((r // b) * nb + h) * b + r % b) * b + r % b))
    diag_idx, _ = _pad_groups(diag_lists, lambda s, g: flat_size)
    for s in range(S):
        diag_idx[s, len(diag_lists[s]):] = flat_size
    diag_idx = diag_idx.astype(np.int32)

    col_idx = (np.arange(nblk_loc)[:, None]
               + np.arange(nb)[None, :]).astype(np.int32)

    # fluid interface ownership by the y-displacement dof
    sdofs = model._solid_dofs.cpu().numpy()
    fdofs_fl = model._fluid_dofs.cpu().numpy()
    n_fl = model._n_area
    own = [[] for _ in range(S)]
    for vk, fk in zip(sdofs, fdofs_fl):
        ydof = vk * dim + 1
        s = ydof // ndof_loc
        own[s].append((int(fk), int(ydof - s * ndof_loc), float(Xref[vk, 1]), int(vk)))
    fl_idx, fl_mask = _pad_groups([[t[0] for t in g] for g in own],
                                  lambda s, g: n_fl)
    nflm = fl_idx.shape[1]
    fl_udof = np.zeros((S, nflm), dtype=np.int32)
    fl_y = np.zeros((S, nflm))
    fl_vert = np.zeros((S, nflm), dtype=np.int32)
    for s in range(S):
        for k, t in enumerate(own[s]):
            fl_udof[s, k], fl_y[s, k], fl_vert[s, k] = t[1], t[2], t[3]
        fl_idx[s, len(own[s]):] = n_fl

    return DDPlan(
        S=S, b=b, h=h, Bt=Bt, m=m, nblk_loc=nblk_loc, ndof_loc=ndof_loc,
        ndof=ndof, ndof_pad=ndof_pad, nvert=nvert, dim=dim, n_fl=n_fl,
        nv=nv, nld=nld, flat_size=flat_size,
        cells=cells_s.astype(np.int32),
        cell_ids=cell_ids.astype(np.int32),
        cell_dofs_loc=cell_dofs_loc.astype(np.int32),
        cell_mask=cell_mask,
        Xe_c=Xref[cells_s],
        fcv=fcv.astype(np.int32),
        f_ids=f_cell_ids.astype(np.int32),
        facet_dofs_loc=facet_dofs_loc.astype(np.int32),
        facet_mask=facet_mask,
        facet_sel=facet_sel,
        facet_opp_sel=facet_opp_sel,
        Xe_f=Xref[fcv],
        bc_mask_loc=bc_mask_loc,
        fill_tgt=fill_tgt,
        diag_idx=diag_idx,
        col_idx=col_idx,
        fl_idx=fl_idx.astype(np.int32),
        fl_udof=fl_udof,
        fl_y=fl_y,
        fl_vert=fl_vert,
        fl_mask=fl_mask,
    )


def plan_dd_banded(model, plan: DDPlan):
    """Per-shard banded-assembly plans (``fem.banded``, ``gc = 128`` as in
    the JAX package) of the sharded cell pass, with their shape metadata
    equal across shards: ``{'meta': (ngroups, gc, nv, w, nvert_pad),
    'plans': [BandedPlan, ...], 'arrays': {...}}``, the arrays those of the
    JAX package's ``plan_dd_banded`` (stacked offsets, each shard's static
    coordinate channels, first vertex and first cell).

    ``None`` where the partition cannot take it: slab boundaries must fall
    on vertices (``ndof_loc % dim == 0`` and ``Bt % dim == 0``) and each
    shard's cells must be a consecutive id range, so that its dg0
    coefficients are a contiguous slice.  A shard without cells (only
    padding dofs) gets a fully masked plan of dummy cells on a unit
    simplex, whose element kernels stay finite."""
    dim = plan.dim
    if plan.ndof_loc % dim or plan.Bt % dim:
        return None
    S = plan.S
    nvert_loc = plan.ndof_loc // dim
    nvert_halo = nvert_loc + plan.Bt // dim
    n_real = plan.cell_mask.sum(axis=1).astype(int)
    ncm, nv = plan.cells.shape[1:]
    c0 = np.zeros(S, dtype=np.int64)
    cells_loc = np.zeros_like(plan.cells)
    for s in range(S):
        if n_real[s] == 0:
            cells_loc[s] = np.broadcast_to(np.arange(nv), (ncm, nv))
            continue
        ids = plan.cell_ids[s, :n_real[s]]
        if n_real[s] > 1 and not (np.diff(ids) == 1).all():
            return None
        c0[s] = ids[0]
        real = plan.cells[s, :n_real[s]] - s * nvert_loc
        pad = np.broadcast_to(real[-1:], (ncm - n_real[s],) + real.shape[1:])
        cells_loc[s] = np.concatenate([real, pad], axis=0)

    # two passes: the common (w, nvert_pad), then the plans with them
    plans = [banded.plan_banded(cells_loc[s], nvert_halo, n_real=int(n_real[s]))
             for s in range(S)]
    w = max(p.w for p in plans)
    nvp = max(max(int(p.base.max()) + w for p in plans), nvert_halo)
    plans = [banded.plan_banded(cells_loc[s], nvert_halo, n_real=int(n_real[s]),
                                w_force=w, nvert_pad_min=nvp)
             for s in range(S)]
    p0 = plans[0]

    Xref = np.asarray(model.solid.residual.mesh().coords)
    nvert_glob = Xref.shape[0]
    Xch = np.zeros((S, dim, nvert_halo))
    for s in range(S):
        lo = s * nvert_loc
        hi = min(lo + nvert_halo, nvert_glob)
        if hi > lo:
            Xch[s, :, :hi - lo] = Xref[lo:hi].T
        if n_real[s] == 0:
            # the dummy cells (vertices 0 .. nv-1) on a unit reference
            # simplex: zero coordinates would make their kernels NaN
            Xch[s] = 0.0
            for v in range(1, nv):
                Xch[s, v - 1, v] = 1.0
    return dict(
        meta=(p0.ngroups, p0.gc, p0.nv, w, nvp),
        plans=plans,
        arrays=dict(
            bb_base=np.stack([p.base for p in plans]).astype(np.int32),
            bb_dg=np.stack([p.delta_g for p in plans]).astype(np.int32),
            bb_ds=np.stack([p.delta_s for p in plans]).astype(np.int32),
            bb_Xch=Xch,
            bb_v0=(np.arange(S) * nvert_loc).astype(np.int32)[:, None],
            bb_c0=c0.astype(np.int32)[:, None],
        ),
    )


class _Scatter:
    """Deterministic per-shard scatter-add of element values into (S, n)
    buffers: ``index`` (S, k) shard-local targets; entries equal to
    ``drop`` are left out (``assembly.ScatterPlan`` over the kept ones)."""

    def __init__(self, index: np.ndarray, n: int, device, drop=None):
        S = index.shape[0]
        glob = index.astype(np.int64) + (np.arange(S) * n)[:, None]
        flat = glob.reshape(-1)
        keep = np.ones(flat.shape, dtype=bool) if drop is None else (
            index.reshape(-1) != drop)
        self.keep = torch.as_tensor(np.nonzero(keep)[0], device=device)
        self.plan = assembly.ScatterPlan(flat[keep][:, None], S * n, device)
        self.shape = (S, n)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        v = values.reshape(-1)[self.keep]
        return self.plan(v[:, None]).reshape(self.shape)


def _coefs(dt):
    """A step's Newmark coefficients: ``dt``'s Python floats, or ``dt``
    itself where it is already a tuple of them (0-d tensors)."""
    return dt if isinstance(dt, tuple) else newmark.coefficients(dt)


class _SolveU1DD(torch.autograd.Function):
    """u1 of one sharded step by the chord Newton with the window's SPIKE
    factors (no graph recorded), ``(u1, *info)``.  Backward: the JAX
    package's IFT rule (``solve_u1_dd_bwd``): the sharded residual rebuilt
    at u1 with the step's coefficient row, ``J^T v`` by autograd through
    it, ``lam`` by the refined transposed SPIKE solve
    (``DDIntegrator._refined_adjoint``), then ``-lam``'s vjp into the
    coefficient row, the extended state (u, v, a), the pressure and the
    properties.  The guess and the factors get no cotangent: the factors
    were built without a graph from detached inputs, and the root does not
    depend on them."""

    @staticmethod
    def forward(dd, fac, dt, keys, guess, row, u0e, v0e, a0e, p1, *prop_vals):
        u1, info = dd._newton(guess, fac, (u0e, v0e, a0e), p1, dict(zip(keys, prop_vals)), dt)
        return (u1.clone() if u1 is guess else u1, *info)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dd, fac, dt, keys, guess, row, *leaves = inputs
        ctx.dd, ctx.fac, ctx.keys = dd, fac, keys
        ctx.save_for_backward(output[0], row, *leaves)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, u1_bar, *_):
        u1, *saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        if u1_bar is None or not any(needs):
            return (None,) * (5 + len(needs))
        dd = ctx.dd
        with torch.enable_grad():
            u = u1.detach().requires_grad_()
            row, u0e, v0e, a0e, p1, *prop_vals = [
                t.detach().requires_grad_(bool(w)) for t, w in zip(saved, needs)]
            r = dd._res_loc(u, (u0e, v0e, a0e), p1, dict(zip(ctx.keys, prop_vals)),
                            tuple(row.unbind(0)))

        def JT(v):
            return torch.autograd.grad(r, u, v, retain_graph=True)[0]

        lam = dd._refined_adjoint(JT, ctx.fac, u1_bar.contiguous())
        leaves = [row, u0e, v0e, a0e, p1, *prop_vals]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(r, wanted, -lam, allow_unused=True))
        return (None,) * 5 + tuple(next(grads) if t.requires_grad else None for t in leaves)


class DDIntegrator:
    """DOF-sharded transient integration of an ``ExplicitFSIModel`` over
    ``n_shards`` shards stacked on the model's device.

    :meth:`integrate_pure` ``(state0, controls_stacked, prop, times)``
    mirrors ``forward.integrate_pure`` (global state in and out);
    :meth:`integrate` mirrors ``forward.integrate`` (its statefile and
    post-run checks, through ``forward.finalize_run``).  ``params`` are
    solver parameters as ``forward.integrate_pure`` takes them; the linear
    solver is always SPIKE, one slab a shard (``btd_store_dtype`` and,
    with it, ``btd_offdiag_dtype`` store its factors; ``btd_factor_dtype``
    factors them in f32), and ``assembly`` is 'plain' (default), 'banded'
    or 'auto'.  Its steps start from the Newmark predictor whatever
    ``initial_guess`` says, as the JAX package's DD step's do."""

    def __init__(self, model, n_shards: int, params: Optional[dict] = None,
                 dp_axis: Optional[str] = None):
        _check_model(model)
        if dp_axis is not None:
            raise NotImplementedError(f"DD stepping with dp_axis (DP x TP): {TODO}")
        if "prop/umesh" in model.solid.residual.coefficient_spec:
            raise NotImplementedError(f"DD stepping with shape parameters: {TODO}")
        self.model = model
        # adjoint solves and their refinement iterations on the gradient path
        self.adjoint_counts = {"solves": 0, "refine_iterations": 0}
        self.params = dict(params or {})
        self.params_d = solver_params(self.params)
        self.plan = plan_dd(model, int(n_shards))
        asm = str(self.params.get("assembly", "plain"))
        if asm == "auto":
            asm = "banded" if model.device.type == "cuda" else "plain"
        self.bplan = None
        if asm == "banded":
            self.bplan = plan_dd_banded(model, self.plan)
            if self.bplan is None:
                raise ValueError(
                    "banded DD assembly unsupported for this partition (dof/vertex"
                    " misalignment or non-contiguous slab cell ids): RCM-renumber"
                    " the mesh (mesh.reorder.rcm_mesh) or take assembly='plain'")
        self._setup()

    # -- static tensors ---------------------------------------------------------
    def _setup(self):
        p, model = self.plan, self.model
        dev, dtype = model.device, model.dtype
        S = p.S

        def t(a):
            a = np.asarray(a)
            return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind in "iu" else dtype,
                                   device=dev)

        self.pst = {k: t(getattr(p, k)) for k in (
            "cells", "cell_ids", "cell_dofs_loc", "cell_mask", "Xe_c", "fcv",
            "f_ids", "facet_dofs_loc", "facet_mask", "facet_sel",
            "facet_opp_sel", "Xe_f", "bc_mask_loc", "col_idx",
            "fl_idx", "fl_udof", "fl_y", "fl_mask")}
        n_ext = p.ndof_loc + p.Bt
        R = model.solid.residual
        self._facets = R.has_facet_pass()
        self._res_c = _Scatter(p.cell_dofs_loc.reshape(S, -1), n_ext, dev)
        self._res_f = _Scatter(p.facet_dofs_loc.reshape(S, -1), n_ext, dev)
        self._fill = _Scatter(p.fill_tgt, p.flat_size + 1, dev, drop=p.flat_size)
        diag = p.diag_idx.astype(np.int64) + (np.arange(S) * (p.flat_size + 1))[:, None]
        self._diag = torch.as_tensor(np.unique(diag[p.diag_idx != p.flat_size]),
                                     device=dev)
        if self.bplan is not None:
            self.dplan = banded.to_device_stacked(self.bplan["plans"], dev)
            a = self.bplan["arrays"]
            self.pst["bb_Xch"] = t(a["bb_Xch"])
            nvert_loc = p.ndof_loc // p.dim
            halo_v = p.Bt // p.dim
            self._nvert_halo = nvert_loc + halo_v
            self._nvert_glob_pad = S * nvert_loc + halo_v
            # each shard's vertex rows v0 + [0, nvert_halo) of a padded
            # global field, and its cells c0 + [0, ncpad)
            self._vrows = t(a["bb_v0"] + np.arange(self._nvert_halo)[None])
            self._crows = t(a["bb_c0"] + np.arange(self.dplan.ncpad)[None])

    # -- element closures (SolidModel._jac_blocks') -------------------------------
    def _with_state(self, local, u1_e, s0_e, dt):
        """The element locals with the state at u1: ``dt`` a float, or the
        step's coefficients as 0-d tensors (the gradient path: the same
        bits, differentiable in the times)."""
        u0_e, v0_e, a0_e = s0_e
        k = _coefs(dt)
        loc = dict(local)
        loc["state/u1"] = u1_e
        loc["state/v1"] = newmark.velocity_k(u1_e, u0_e, v0_e, a0_e, k)
        loc["state/a1"] = newmark.acceleration_k(u1_e, u0_e, v0_e, a0_e, k)
        return loc

    def _cell_fn(self, dt):
        cell_elem = self.model.solid.residual.cell_elem_fn()

        def f(u1_e, Xe, s0_e, local):
            return cell_elem(Xe, self._with_state(local, u1_e, s0_e, dt))

        return f

    def _facet_fn(self, dt):
        facet_elem = self.model.solid.residual.facet_elem_fn()
        contact = self.model.solid._has_contact

        def f(u1_e, Xe, sel, opp_sel, s0_e, local):
            loc = self._with_state(local, u1_e, s0_e, dt)
            if contact:
                loc["control/tcontact"] = _contact_traction(
                    u1_e, Xe, loc["prop/ncontact"], loc["prop/ycontact"],
                    loc["prop/kcontact"])
            return facet_elem(Xe, sel, opp_sel, loc)

        return f

    def _gather_locals(self, fields, facet):
        """Per-element coefficient locals over shards x elements, and their
        ``vmap`` dims (state and contact traction are set per element)."""
        pst = self.pst
        verts = (pst["fcv"] if facet else pst["cells"]).flatten(0, 1)
        ids = (pst["f_ids"] if facet else pst["cell_ids"]).flatten(0, 1)
        local, axes = {}, {}
        for key, sp_ in self.model.solid.residual.coefficient_spec.items():
            if key.startswith("state/") or key == "control/tcontact":
                continue
            arr = fields[key]
            if sp_.space in ("cg1_vector", "cg1_scalar"):
                local[key], axes[key] = arr[verts], 0
            elif sp_.space == "dg0_scalar":
                local[key], axes[key] = arr[ids], 0
            else:
                local[key] = arr[0] if sp_.space == "const_scalar" else arr
                axes[key] = None
        return local, axes

    def _make_fields(self, prop_s, p1):
        solid = self.model.solid
        fields = dict(solid._prop_fields(prop_s))
        if solid._has_p1:
            fields["control/p1"] = p1
        return fields

    def _elem_inputs(self, u_ext, ext0, facet):
        """Element values of the shard-extended vectors (S, ndof_loc + Bt):
        u1 and the state (u, v, a), each (S ne, nv, dim)."""
        p = self.plan
        cd = self.pst["facet_dofs_loc" if facet else "cell_dofs_loc"]
        idx = cd.reshape(p.S, -1)

        def take(x):
            return torch.gather(x, 1, idx).reshape(-1, p.nv, p.dim)

        return take(u_ext), tuple(take(x) for x in ext0)

    # -- residual ------------------------------------------------------------------
    def _facet_res(self, u1_ext, ext0, fields, dt):
        pst = self.pst
        u1_f, s0_f = self._elem_inputs(u1_ext, ext0, True)
        local, _ = self._gather_locals(fields, True)
        res = self._facet_fn(dt)(u1_f, pst["Xe_f"].flatten(0, 1),
                                 pst["facet_sel"].flatten(0, 1),
                                 pst["facet_opp_sel"].flatten(0, 1), s0_f, local)
        res = res * pst["facet_mask"].reshape(-1, 1, 1)
        return self._res_f(res.reshape(self.plan.S, -1))

    def _cell_res_plain(self, u1_ext, ext0, fields, dt):
        pst = self.pst
        u1_e, s0_e = self._elem_inputs(u1_ext, ext0, False)
        local, _ = self._gather_locals(fields, False)
        res = self._cell_fn(dt)(u1_e, pst["Xe_c"].flatten(0, 1), s0_e, local)
        res = res * pst["cell_mask"].reshape(-1, 1, 1)
        return self._res_c(res.reshape(self.plan.S, -1))

    def _cell_res_banded(self, u1_ext, ext0, fields, dt):
        """The cell pass through K1 and K2 on the stacked per-shard plans:
        every cg1 channel (u1, the state, the coefficients, the static
        coordinates) in one gather, the element kernel over shards x cells,
        one scatter; the padded duplicate cells are masked by the scatter
        offsets."""
        p, dplan = self.plan, self.dplan
        S, dim, nvh = p.S, p.dim, self._nvert_halo

        def vcomps(x):  # (S, ndof_loc + Bt) -> (S, dim, nvert_halo)
            return x.reshape(S, nvh, dim).transpose(1, 2)

        def slab_rows(arr2):  # (nvert, k) global -> (S, k, nvert_halo)
            arr2 = torch.nn.functional.pad(
                arr2, (0, 0, 0, self._nvert_glob_pad - arr2.shape[0]))
            return arr2[self._vrows].transpose(1, 2)

        comps = [vcomps(u1_ext)] + [vcomps(x) for x in ext0]
        layout = [("u1", dim), ("u0", dim), ("v0", dim), ("a0", dim)]
        spec = self.model.solid.residual.coefficient_spec
        for key, sp_ in spec.items():
            if key.startswith("state/") or key == "control/tcontact":
                continue
            if sp_.space in ("cg1_vector", "cg1_scalar"):
                k = dim if sp_.space == "cg1_vector" else 1
                comps.append(slab_rows(fields[key].reshape(-1, k)))
                layout.append((key, k))
        comps.append(self.pst["bb_Xch"])
        layout.append(("X", dim))
        F = torch.cat(comps, dim=1).contiguous()  # (S, C, nvert_halo)
        loc_all = banded.banded_gather_t(dplan, F)  # (S, nv, C, ncpad)

        # element kernels take the cell axis first: (S ncpad, nv, k) views
        vals, c0 = {}, 0
        for key, k in layout:
            v = loc_all[:, :, c0:c0 + k].permute(0, 3, 1, 2).flatten(0, 1)
            c0 += k
            vals[key] = v if k > 1 else v[..., 0]
        local = {key: vals[key] for key, _ in layout[4:-1]}
        for key, sp_ in spec.items():
            arr = fields.get(key)
            if sp_.space == "dg0_scalar":
                arr = torch.nn.functional.pad(arr, (0, dplan.ncpad))
                local[key] = arr[self._crows].reshape(-1)
            elif sp_.space == "const_scalar":
                local[key] = arr[0]
            elif sp_.space == "const_vector":
                local[key] = arr
        res = self._cell_fn(dt)(vals["u1"], vals["X"],
                                (vals["u0"], vals["v0"], vals["a0"]), local)
        res = res.reshape(S, dplan.ncpad, p.nv, dim).permute(0, 2, 3, 1).contiguous()
        r2 = banded.banded_scatter_t(dplan, res, nvh)  # (S, dim, nvert_halo)
        return r2.transpose(1, 2).reshape(S, -1)

    def _res_loc(self, u1_loc, ext0, p1, prop_s, dt):
        """The sharded Newton residual (S, ndof_loc); Dirichlet and padding
        rows read ``u1``."""
        p = self.plan
        u1_ext = torch.cat([u1_loc, shards.halo_right(u1_loc, p.Bt)], dim=1)
        fields = self._make_fields(prop_s, p1)
        cell = self._cell_res_banded if self.bplan is not None else self._cell_res_plain
        buf = cell(u1_ext, ext0, fields, dt)
        if self._facets:
            buf = buf + self._facet_res(u1_ext, ext0, fields, dt)
        r = shards.spill_add(buf, p.ndof_loc)
        bcm = self.pst["bc_mask_loc"]
        return r * (1.0 - bcm) + u1_loc * bcm

    # -- banded fill and SPIKE factors ------------------------------------------------
    def _factorize_loc(self, ext0, p1, prop_s, dt, with_transpose=False):
        """Each shard's slab of the block-banded Jacobian at the predictor,
        filled from the element blocks, with the previous shard's spilled
        block rows added, equilibrated with the neighbours' scale halos,
        and SPIKE-factored: a ``solvers.spike.SPIKEFactors`` whose
        ``d`` is the shards' scale (S, ndof_loc), with the transposed parts
        where ``with_transpose`` (a differentiable run)."""
        from torch.func import jacfwd, vmap

        p, pst = self.plan, self.pst
        S, b, h, nld = p.S, p.b, p.h, p.nld
        nb = 2 * h + 1
        u_lin = ext0[0] + dt * ext0[1] + 0.5 * dt * dt * ext0[2]
        fields = self._make_fields(prop_s, p1)
        u1_e, s0_e = self._elem_inputs(u_lin, ext0, False)
        local, axes = self._gather_locals(fields, False)
        Jc = vmap(jacfwd(self._cell_fn(dt)), in_dims=(0, 0, 0, axes))(
            u1_e, pst["Xe_c"].flatten(0, 1), s0_e, local).reshape(-1, nld, nld)
        Jc = Jc * pst["cell_mask"].reshape(-1, 1, 1)
        src = [Jc.reshape(S, -1)]
        if self._facets:
            u1_f, s0_f = self._elem_inputs(u_lin, ext0, True)
            local, axes = self._gather_locals(fields, True)
            Jf = vmap(jacfwd(self._facet_fn(dt)), in_dims=(0, 0, 0, 0, 0, axes))(
                u1_f, pst["Xe_f"].flatten(0, 1), pst["facet_sel"].flatten(0, 1),
                pst["facet_opp_sel"].flatten(0, 1), s0_f, local).reshape(-1, nld, nld)
            Jf = Jf * pst["facet_mask"].reshape(-1, 1, 1)
            src.append(Jf.reshape(S, -1))
        flat = self._fill(torch.cat(src, dim=1)).reshape(-1)
        flat[self._diag] += 1.0
        full = flat.reshape(S, -1)[:, :p.flat_size].reshape(S, p.nblk_loc + h, nb, b, b)
        # absorb the previous shard's spilled block rows
        band = full[:, :p.nblk_loc].clone()
        band[:, :h] += shards.shift_from_prev(full[:, p.nblk_loc:])
        # f64 residuals, f32 factors (btd_factor_dtype)
        band = btd.factor_blocks(band, self.params_d.get("btd_factor_dtype"))

        # symmetric Jacobi equilibration with the neighbours' scale halos
        diag = torch.diagonal(band[:, :, h], dim1=-2, dim2=-1)  # (S, nblk_loc, b)
        d_loc = torch.sqrt(torch.abs(diag) + 1e-30).reshape(S, -1)
        d_ext = torch.cat([shards.shift_from_prev(d_loc[:, -h * b:]), d_loc,
                           shards.shift_from_next(d_loc[:, :h * b])], dim=1)
        d_ext = torch.where(d_ext == 0.0, 1.0, d_ext)
        dr = d_loc.reshape(S, p.nblk_loc, b)
        dc = d_ext.reshape(S, p.nblk_loc + 2 * h, b)[:, pst["col_idx"]]
        band = band / dr[:, :, None, :, None] / dc[:, :, :, None, :]

        shim = SimpleNamespace(b=b, h=h, nb=nb, nblk=S * p.nblk_loc)
        D, L, U = (x.reshape(S, p.m, p.Bt, p.Bt)
                   for x in btd._btd_from_bsb(shim, band.reshape(-1, nb, b, b)))
        fac = spike.factor_slabs(*spike.split_slabs(D, L, U), d_loc,
                                 with_transpose=with_transpose)
        # as the JAX package's DD step, btd_offdiag_dtype applies only
        # with btd_store_dtype set
        sd = self.params_d.get("btd_store_dtype")
        od = self.params_d.get("btd_offdiag_dtype") if sd is not None else None
        return spike.store(fac, sd, od)

    def _spike_apply(self, fac, r, transpose=False):
        """``A^-1 r`` (``A^-T r`` with ``transpose``) of a sharded vector
        with the SPIKE factors of the shards' slabs."""
        p = self.plan
        solve = spike.solve_slabs_t if transpose else spike.solve_slabs
        x = solve(fac, (r / fac.d).reshape(p.S, p.m, p.Bt))
        return x.reshape(p.S, -1) / fac.d

    # -- the coupled step -------------------------------------------------------------
    def _ext(self, state):
        Bt = self.plan.Bt
        return tuple(torch.cat([state[k], shards.halo_right(state[k], Bt)], dim=1)
                     for k in ("u", "v", "a"))

    def _split(self, prop):
        model = self.model
        return ({k: prop[k] for k in model._solid_prop_keys},
                {k: prop[k] for k in model._fluid_prop_keys})

    def _factorize_step(self, state, prop, dt, with_transpose=False):
        prop_s, _ = self._split(prop)
        p1 = self.model._pressure_to_solid(state["p"])
        return self._factorize_loc(self._ext(state), p1, prop_s, dt, with_transpose)

    def _newton(self, guess, fac, ext0, p1, prop_s, dt):
        """The chord Newton of one step on the sharded vector, solving with
        the window's factors: ``(u1, info)``."""
        shape = guess.shape

        def assem(u1):
            return self._res_loc(u1.reshape(shape), ext0, p1, prop_s, dt).reshape(-1)

        def solve_jac(u1, r):
            return self._spike_apply(fac, r.reshape(shape)).reshape(-1)

        u1, info = newton_solve(guess.reshape(-1), assem, solve_jac, self.params_d,
                                norm_fn=lambda r: shards.pnorm(r.reshape(shape)))
        return u1.reshape(shape), info

    def _refined_adjoint(self, JT, fac, u1_bar):
        """``lam`` with ``J(u1)^T lam = u1_bar`` (sharded vectors): the
        single-device refinement (``models.transient.refined_adjoint``)
        with the window's SPIKE factors as the transposed preconditioner
        and the norms summed over the shards (the JAX package's loop)."""
        lam, k = refined_adjoint(JT, lambda r: self._spike_apply(fac, r, transpose=True),
                                 shards.pnorm, u1_bar, self.params_d)
        self.adjoint_counts["solves"] += 1
        self.adjoint_counts["refine_iterations"] += k
        return lam

    def _step_loc(self, state, fac, control, prop, dt, row=None):
        """One step of the sharded state ``u, v, a`` (S, ndof_loc) and the
        fluid's ``q, p``; with ``row``, the step's coefficient row
        (``equations.newmark.coefficient_rows``), a differentiable step
        (:class:`_SolveU1DD`) of the same values."""
        model, p, pst = self.model, self.plan, self.pst
        prop_s, prop_f = self._split(prop)
        p1 = model._pressure_to_solid(state["p"])
        ext0 = self._ext(state)
        u, v, a = state["u"], state["v"], state["a"]
        if row is None:
            u_guess = u + dt * v + 0.5 * dt * dt * a
            u1, info = self._newton(u_guess, fac, ext0, p1, prop_s, dt)
            k = newmark.coefficients(dt)
        else:
            u_guess = u.detach() + dt * v.detach() + 0.5 * dt * dt * a.detach()
            keys = list(prop_s)
            out = _SolveU1DD.apply(self, fac, dt, keys, u_guess, row, *ext0, p1,
                                   *(prop_s[k] for k in keys))
            u1, info = out[0], SolveInfo(*out[1:])
            k = tuple(row.unbind(0))
        v1 = newmark.velocity_k(u1, u, v, a, k)
        a1 = newmark.acceleration_k(u1, u, v, a, k)

        # fluid: each shard's surface areas, summed over the shards
        vals = 2.0 * (prop["ymid"][0] - pst["fl_y"]
                      - torch.gather(u1, 1, pst["fl_udof"])) * pst["fl_mask"]
        area = vals.new_zeros(p.n_fl + 1).index_add_(
            0, pst["fl_idx"].reshape(-1), vals.reshape(-1))[:p.n_fl]
        fl_control = {"area": area, **{k: control[k] for k in model._control_keys}}
        qp1 = model.fluid.solve_pure(fl_control, prop_f,
                                     {"q": state["q"], "p": state["p"]})
        return {"u": u1, "v": v1, "a": a1, **qp1}, info

    # -- runs ---------------------------------------------------------------------------
    def integrate_pure(self, state0, controls_stacked, prop, times):
        """The sharded counterpart of ``forward.integrate_pure``: global
        state in (numpy or tensors), ``(fin_state, trajectory, infos)``
        out, tensors on the model's device with the global layout.  The
        factors are rebuilt every ``jacobian_refresh_steps`` steps.  Inputs
        that require grad (the times as a float64 tensor) make the run
        differentiable (:class:`_SolveU1DD` a step), its values the no-grad
        run's bit for bit."""
        diff = fwd._wants_grad(state0, controls_stacked, prop, times)
        model, p = self.model, self.plan
        dev, dtype = model.device, model.dtype
        with torch.set_grad_enabled(diff):
            state = to_tensors(state0, dev, dtype)
            controls = to_tensors(controls_stacked, dev, dtype)
            prop = to_tensors(prop, dev, dtype)
            times_t = torch.as_tensor(times if isinstance(times, torch.Tensor)
                                      else np.asarray(times, dtype=np.float64))
            times_t = times_t.to(device=dev, dtype=torch.float64)
            dts = [float(x) for x in np.diff(np.array(times_t.detach().cpu().tolist()))]
            n_steps = len(dts)
            if not n_steps:
                raise ValueError("integrate_pure needs at least two time points")
            rows = newmark.coefficient_rows(times_t[1:] - times_t[:-1]).to(dtype) if diff else None
            n_controls = next(iter(controls.values())).shape[0]
            pad = p.ndof_pad - p.ndof
            for k in ("u", "v", "a"):
                state[k] = torch.nn.functional.pad(state[k], (0, pad)).reshape(p.S, -1)
            traj, infos = [], []
            windows = {"jacobian_refresh_steps":
                       int(self.params_d.get("jacobian_refresh_steps", 1))}
            for n0, n1, _ in refresh_windows(n_steps, windows):
                with torch.no_grad():
                    fac = self._factorize_step({k: v.detach() for k, v in state.items()},
                                               {k: v.detach() for k, v in prop.items()},
                                               dts[n0], with_transpose=diff)
                for n in range(n0, n1):
                    control = {k: c[min(n, n_controls - 1)] for k, c in controls.items()}
                    state, info = self._step_loc(state, fac, control, prop, dts[n],
                                                 None if rows is None else rows[n])
                    traj.append(state)
                    infos.append(info)

        def glob(s):
            return {k: (v.reshape(-1)[:p.ndof] if k in "uva" else v)
                    for k, v in s.items()}

        trajectory = {k: torch.stack([glob(s)[k] for s in traj]) for k in traj[0]}
        info = SolveInfo(*(torch.stack(x).detach() for x in zip(*infos)))
        return glob(state), trajectory, info

    def integrate_batch_pure(self, *args, **kwargs):
        raise NotImplementedError(f"DD stepping over a DP batch: {TODO}")

    def integrate(self, f, ini_state, controls, prop, times, idx_meas=None,
                  write=True):
        """The sharded counterpart of ``forward.integrate``: the run of
        :meth:`integrate_pure`, then ``forward.finalize_run`` (statefile
        writes, divergence flags, fixed-iteration certification).
        Returns ``(fin_state, last_info)``."""
        times = fwd.validate_times(times)
        state0 = to_numpy(ini_state)
        controls_stacked = fwd._stack_controls(self.model, controls)
        fin, traj, infos = self.integrate_pure(state0, controls_stacked,
                                               to_numpy(prop), times)
        return fwd.finalize_run(self.model, f, ini_state, controls, prop, times,
                                idx_meas, self.params, fin, traj, infos, write)
