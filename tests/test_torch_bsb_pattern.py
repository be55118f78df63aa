"""
K4's matvec pattern (``solvers.bsb.matvec_pattern``) and the order of the
pattern kernel, on the CPU: the pattern holds exactly what ``bsb_fill`` can
write; a numpy emulation of K4's summation order (``tests/bsb_emulation.py``,
the card tests' bit-level reference) matches the JAX package's matvec and
its Pallas kernel (interpret mode) on the model's own fill; the
``sparse.mm`` yardstick built from the pattern is the plain matvec; and the
bytes of K4's bound are counted from the pattern.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu.ops.pallas_kernels import bsb_matvec_pallas
from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu_torch import ops, yardsticks
from vf_fem_tpu_torch.ops import kernels
from vf_fem_tpu_torch.solvers import bsb as tbsb

from bsb_emulation import emulate_bsb_matvec
from port_fixtures import MESHES, REPO, jax_vf_model, port_vf_model, solid_args

NX, NY = 10, 5
RTOL = {np.float64: 1e-13, np.float32: 1e-6}
DTYPES = [np.float64, np.float32]


@pytest.fixture(scope="module")
def models():
    jm = jax_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    tm = port_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    return jm, tm


@pytest.fixture(scope="module")
def fill(models):
    """The port's plan, its device fill and the model's own block array
    (the Jacobian at rest under 500 Ba), f64."""
    jm, tm = models
    _, (s0, c, p) = solid_args(jm, 500.0)
    op = tm.solid.jac_u_ebe(s0["u"], s0, c, p, 1e-4)
    plan, dfill = tm.solid.bsb_plan()
    return plan, dfill, tbsb.bsb_fill(plan, dfill, [op.J_cells, op.J_facets])


def _flat(plan, pattern):
    """Flat indices into blocks of the pattern's entries, with their rows
    and columns."""
    b, bb = plan.b, plan.b * plan.b
    ptr, off = (np.asarray(a, dtype=np.int64) for a in pattern)
    rows = np.repeat(np.arange(plan.ndof), np.diff(ptr))
    n = rows // b
    return n * plan.nb * bb + off, rows, (n + off // bb - plan.h) * b + off % b


def test_plan_covers_dirichlet_rows_and_ragged_tail(fill):
    """The small mesh exercises both edges of K4: identity rows and a last
    block row that is only partly inside ndof."""
    plan, _, _ = fill
    assert plan.bc_dofs.size > 0
    assert plan.ndof % plan.b != 0 and plan.nblk > 1


def test_pattern_is_what_the_fill_writes(fill):
    """Every pattern entry is a fill target (kept) or a Dirichlet one, every
    such entry is in the pattern once, rows are CSR with columns ascending,
    and with random element Jacobians ``bsb_fill`` leaves the band exactly
    zero outside the pattern."""
    plan, dfill, _ = fill
    pattern = tbsb.matvec_pattern(plan)
    for a, t in zip(pattern, dfill.pattern):
        assert a.dtype == np.int32 and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), a)
    flat, rows, cols = _flat(plan, pattern)
    want = np.union1d(plan.tgt_idx[plan.src_keep], plan.diag_ones)
    np.testing.assert_array_equal(np.sort(flat), want)
    assert (pattern.off >= 0).all() and (pattern.off < plan.nb * plan.b ** 2).all()
    assert (cols >= 0).all() and (cols < plan.ndof).all()
    assert (np.diff(pattern.ptr) >= 1).all()  # no empty row
    same_row = rows[1:] == rows[:-1]
    assert (cols[1:][same_row] > cols[:-1][same_row]).all()

    # random element Jacobians, flattened in the plan's source order
    src = torch.tensor(np.random.default_rng(0).standard_normal(plan.tgt_idx.size))
    blocks = tbsb.bsb_fill(plan, dfill, [src]).numpy().reshape(-1)
    outside = np.ones(blocks.size, dtype=bool)
    outside[flat] = False
    assert not blocks[outside].any()
    assert np.count_nonzero(blocks[flat]) == flat.size  # random: no zero inside


@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_order_matches_jax(models, fill, dtype):
    """K4's order (emulated, its 4 lanes a row) against the JAX package's
    ``bsb_matvec`` and ``bsb_matvec_pallas`` (interpret mode) on the
    model's fill: within rtol 1e-13 / 1e-6 (f64 / f32) plus the
    dot-product order bound."""
    jm, _ = models
    plan, dfill, blocks64 = fill
    blocks = blocks64.numpy().astype(dtype)
    x = np.random.default_rng(4).standard_normal(plan.ndof).astype(dtype)
    y = emulate_bsb_matvec(plan, dfill.pattern, blocks, x, kernels.BSB_LANES)
    assert y.dtype == dtype and y.shape == (plan.ndof,)
    jplan = jm.solid._get_bsb_plan()
    bound = ops.dot_order_bound(ops.bsb_matvec_reference(
        plan, torch.from_numpy(np.abs(blocks)), torch.from_numpy(np.abs(x))),
        plan.nb * plan.b).numpy()
    for ref in (jbsb.bsb_matvec(jplan, jnp.asarray(blocks), jnp.asarray(x)),
                bsb_matvec_pallas(jplan, jnp.asarray(blocks), jnp.asarray(x), tile=8)):
        ref = np.asarray(ref)
        assert (np.abs(y - ref) <= RTOL[dtype] * np.abs(ref) + bound).all()


def test_emulation_sums_in_lane_order():
    """The emulation adds lane by lane, then across the xor tree: a row of
    2^53, 1, -2^53, 1 (times ones) gives (2^53 - 2^53) + (1 + 1) = 2 with 2,
    4 or 8 lanes, where its own order gives ((2^53 + 1) - 2^53) + 1 = 1."""
    plan = tbsb.BSBPlan(ndof=4, b=128, nblk=1, nb=1, h=0, tgt_idx=np.zeros(1, np.int32),
                        src_keep=np.ones(1, bool), bc_dofs=np.zeros(0, np.int32),
                        diag_ones=np.zeros(0, np.int32))
    pattern = tbsb.MatvecPattern(ptr=np.array([0, 4, 4, 4, 4], np.int32),
                                 off=np.arange(4, dtype=np.int32))
    blocks = np.zeros((1, 1, 128, 128))
    blocks[0, 0, 0, :4] = [2.0 ** 53, 1.0, -(2.0 ** 53), 1.0]
    for lanes in (2, 4, 8):
        y = emulate_bsb_matvec(plan, pattern, blocks, np.ones(4), lanes)
        np.testing.assert_array_equal(y, [2.0, 0.0, 0.0, 0.0])
    assert ((2.0 ** 53 + 1.0) - 2.0 ** 53) + 1.0 == 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_pattern_csr_is_the_matvec(fill, dtype):
    """``yardsticks.bsb_csr`` from the pattern (the entries K4 reads, zeros
    included) times x equals the plain matvec within the order bound."""
    plan, dfill, blocks64 = fill
    B = blocks64.to(torch.float64 if dtype == np.float64 else torch.float32)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(plan.ndof).astype(dtype))
    csr = yardsticks.bsb_csr(plan, B, dfill.pattern)
    assert csr.values().numel() == dfill.pattern.off.numel()
    out = yardsticks.csr_mm(csr, x).reshape(-1)
    ref = ops.bsb_matvec_reference(plan, B, x)
    bound = ops.dot_order_bound(ops.bsb_matvec_reference(plan, B.abs(), x.abs()),
                                plan.nb * plan.b)
    assert bool(((out - ref).abs() <= RTOL[dtype] * ref.abs() + bound).all())


def test_bound_counts_the_pattern_bytes():
    """K4's bound in ``chip_smoke.py`` counts what the pattern needs: each
    value and its int32 offset, the row pointers, x and y; 2 operations an
    entry.  At 23.7k dofs (the RCM mesh of the Krylov path) the pattern
    holds 326,410 entries, 1-18 a row: 4.39 MB in f64 and 2.90 MB in f32,
    against the 121.9 MB of the dense band in f64."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    model = load_fsi_model(os.path.join(MESHES, "M5_3layers_rcm_h006.msh"),
                           slr.KelvinVoigtWEpithelium, flr.BernoulliAreaRatioSep,
                           device="cpu")
    s = model.solid
    plan = tbsb.plan_bsb(s._elem_dofs, s.ndof, s._residual.bc_dofs)
    pattern = tbsb.matvec_pattern(plan)
    nnz, ndof = pattern.off.size, plan.ndof
    assert (nnz, ndof) == (326410, 23754)
    per_row = np.diff(pattern.ptr)
    assert (per_row.min(), per_row.max()) == (1, 18)
    for es, mb in ((8, 4.392004), (4, 2.896332)):
        nbytes, nops = chip_smoke.bsb_work(pattern, ndof, es)
        assert nbytes == nnz * (es + 4) + (ndof + 1) * 4 + 2 * ndof * es
        assert nbytes == round(mb * 1e6) and nops == 2 * nnz
    assert chip_smoke.bsb_band_bytes(plan, 8) == 186 * 5 * 128 * 128 * 8 + 2 * ndof * 8
