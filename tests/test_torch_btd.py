"""
The port's block-Thomas direct path (``linear_solver='btd'``) against the
JAX package on the CPU in f64, on the RCM-renumbered ``vocal_fold_mesh(10,
5)`` of ``tests/test_torch_krylov.py`` with KelvinVoigtWEpithelium +
BernoulliAreaRatioSep: the super-block regrouping, the product-form
factors (f64 and bf16 storage), the solve (on the JAX package's own
factors and against a dense solve), the plain version of the sweep kernel
K6, and whole ``integrate_pure`` trajectories, including a small run with
the production settings of ``bench.py:411-434`` (bf16 factors, fixed-3
tail-free chord).

Two block-banded plans of the same Jacobian: the model's own (``b =
128``: two super-rows, identity tail rows) and ``b = 8`` (nine super-rows
of 16, one identity pad row and identity tail rows).
"""

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu.solvers import btd as jbtd
from vf_fem_tpu_torch import forward as tforward
from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.convert import array_to_tensor, to_numpy
from vf_fem_tpu_torch.fem import assembly as tassembly
from vf_fem_tpu_torch.solvers import bsb as tbsb
from vf_fem_tpu_torch.solvers import btd as tbtd

from port_fixtures import (
    jax_inputs, jax_vf_model, port_inputs, port_vf_model, solid_args,
)

NX, NY = 10, 5
DT = 1e-4
F32_U = 2.0 ** -24  # f32 unit roundoff

# bench.py:411-434, with the refresh window cut from 96 to 8 so that a
# 20-step run takes a refresh and a remainder window
PROD_SMALL = {
    "linear_solver": "btd",
    "btd_store_dtype": "bfloat16",
    "jacobian_refresh_steps": 8,
    "fixed_iterations": 3,
    "fixed_tail_residual": False,
    "stagnation_ratio": 0.5,
}
# bench.py:459-466: the same settings with exact (refresh-1, f64) factors
EXACT_SMALL = {**{k: v for k, v in PROD_SMALL.items()
                  if k != "btd_store_dtype"}, "jacobian_refresh_steps": 1}
# max|x_port - x_jax| / max|x_jax| over the 20-step PROD_SMALL trajectory,
# measured on a CPU (x86-64): the bf16 factors' f32 matvecs sum in another
# order in the two packages, and the fixed-3 chord carries what that
# changes; each field is held at 10x its difference
PROD_SMALL_DIFF = {"u": 6.868e-08, "v": 9.069e-07, "a": 1.940e-06,
                   "q": 6.874e-10, "p": 2.625e-09}


@pytest.fixture(scope="module")
def models():
    jm = jax_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    tm = port_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    return jm, tm


@pytest.fixture(scope="module", params=[128, 8], ids=["b128", "b8"])
def banded(request, models):
    """(JAX plan, JAX blocks, port plan, port blocks): the Jacobian at rest
    under 500 Ba in block-banded storage of block size b."""
    jm, tm = models
    (s0j, cj, pj), (s0t, ct, pt) = solid_args(jm, 500.0)
    opj = jm.solid.jac_u_ebe(s0j["u"], s0j, cj, pj, DT)
    opt = tm.solid.jac_u_ebe(s0t["u"], s0t, ct, pt, DT)
    b = request.param
    jp = jbsb.plan_bsb([jm.solid._cell_dofs, jm.solid._facet_cell_dofs],
                       jm.solid.ndof, jm.solid._get_bsb_plan().bc_dofs, b=b)
    tp = tbsb.plan_bsb(tm.solid._elem_dofs, tm.solid.ndof,
                       tm.solid.residual.bc_dofs, b=b)
    bj = jbsb.bsb_fill(jp, [opj.J_cells, opj.J_facets])
    bt = tbsb.bsb_fill(tp, tbsb.fill_plan(tp, "cpu"),
                       [opt.J_cells, opt.J_facets])
    return jp, bj, tp, bt


def _rel_close(a, b, rtol, what=""):
    """max|a - b| <= rtol max|b| (fields whose small entries are rounding
    residues of structural zeros)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max()
    assert err <= rtol * np.abs(b).max(), f"{what}: {err:.3e} of max {np.abs(b).max():.3e}"


def test_superblocks_match(banded):
    jp, bj, tp, bt = banded
    n_sup = -(-tp.nblk // tp.h)
    if tp.b == 8:  # both identity branches of btd_superblocks are taken
        assert n_sup * tp.h > tp.nblk
    assert tp.ndof - (tp.nblk - 1) * tp.b < tp.b
    for name, a, r in zip("DLUd", tbtd.btd_superblocks(tp, bt),
                          jbtd.btd_superblocks(jp, bj)):
        assert tuple(a.shape) == tuple(r.shape), name
        _rel_close(a, r, 1e-13, name)


def test_factor_matches(banded):
    """f64 factors: max|diff| <= 1e-12 max|field| (the n_sup serial
    inverses amplify roundoff by the Schur complements' conditioning)."""
    jp, bj, tp, bt = banded
    ft, fj = tbtd.btd_factor(tp, bt), jbtd.btd_factor(jp, bj)
    for f in fj._fields:
        assert getattr(ft, f).dtype == torch.float64, f
        _rel_close(getattr(ft, f), getattr(fj, f), 1e-12, f)


def test_bf16_factors_within_one_ulp(banded):
    """bf16 factors: each entry within one bf16 ulp of the JAX package's,
    except the rounding residues of structural zeros (|x| < 1e-13
    max|X|, where the f64 factors themselves differ), held within
    1e-13 max|X|."""
    jp, bj, tp, bt = banded
    ft = tbtd.btd_factor(tp, bt, store_dtype="bfloat16")
    fj = jbtd.btd_factor(jp, bj, store_dtype="bfloat16")
    for f in ("Sinv", "V", "W"):
        a = getattr(ft, f)
        assert a.dtype == torch.bfloat16, f
        a = a.double().numpy()
        r = np.asarray(getattr(fj, f)).astype(np.float64)
        floor = 1e-13 * np.abs(r).max()
        ulp = np.spacing(np.abs(r).astype(np.float32)).astype(np.float64) * 2.0 ** 16
        ok = (np.abs(a - r) <= ulp) | ((np.abs(r) < floor) & (np.abs(a - r) <= floor))
        assert ok.all(), f"{f}: {int((~ok).sum())} entries off"
    _rel_close(ft.d, fj.d, 1e-15, "d")


@pytest.mark.parametrize("store", [None, "bfloat16"], ids=["f64", "bf16"])
def test_solve_on_jax_factors(banded, store):
    """btd_solve of the port on the JAX package's own factors (converted by
    ``convert.array_to_tensor``) against the JAX package's btd_solve:
    1e-13 of max|x| with f64 factors; with bf16 factors (f32 sums in
    another order) within the f32 summation bound of one block row,
    2 gamma_Bt(f32) max|x|."""
    jp, bj, tp, bt = banded
    fj = jbtd.btd_factor(jp, bj, store_dtype=store)
    ft = tbtd.BTDFactors(*(array_to_tensor(x, "cpu") for x in fj))
    r = np.random.default_rng(0).standard_normal(tp.ndof)
    before = dict(ops.LAUNCHES)
    x = tbtd.btd_solve(tp, ft, torch.as_tensor(r))
    assert ops.LAUNCHES == before  # CPU tensors: the plain sweep
    xj = np.asarray(jbtd.btd_solve(jp, fj, jnp.asarray(r)))
    Bt = ft.Sinv.shape[-1]
    rtol = 1e-13 if store is None else 2 * Bt * F32_U / (1 - Bt * F32_U)
    _rel_close(x, xj, rtol, f"x ({store})")


def _dense(plan, blocks):
    """The Jacobian as a dense (ndof, ndof) array, from its band storage."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    B = np.asarray(blocks)
    A = np.zeros((nblk * b, nblk * b))
    for n in range(nblk):
        for m in range(nb):
            c = n + m - h
            if 0 <= c < nblk:
                A[n * b:(n + 1) * b, c * b:(c + 1) * b] = B[n, m]
    return A[: plan.ndof, : plan.ndof]


def test_solve_matches_dense(banded):
    """The port's factors and solve against a numpy dense solve, as
    tests/test_bsb.py:213-215 holds the JAX package."""
    _, _, tp, bt = banded
    r = np.random.default_rng(0).standard_normal(tp.ndof)
    x = tbtd.btd_solve(tp, tbtd.btd_factor(tp, bt), torch.as_tensor(r))
    xr = np.linalg.solve(_dense(tp, bt), r)
    np.testing.assert_allclose(x.numpy(), xr, rtol=1e-9, atol=1e-11)


def test_bf16_refinement_contracts(banded):
    """bf16 factors solve to ~1e-2, and one step of iterative refinement
    (the chord Newton's use) contracts the error (tests/test_bsb.py:
    224-231)."""
    _, _, tp, bt = banded
    A = _dense(tp, bt)
    r = np.random.default_rng(0).standard_normal(tp.ndof)
    xr = np.linalg.solve(A, r)
    fac16 = tbtd.btd_factor(tp, bt, store_dtype="bfloat16")
    x16 = tbtd.btd_solve(tp, fac16, torch.as_tensor(r)).numpy()
    rel0 = np.linalg.norm(x16 - xr) / np.linalg.norm(xr)
    assert rel0 < 5e-2
    x16b = x16 + tbtd.btd_solve(tp, fac16, torch.as_tensor(r - A @ x16)).numpy()
    rel1 = np.linalg.norm(x16b - xr) / np.linalg.norm(xr)
    assert rel1 < 0.3 * rel0


def test_unsupported_store_dtype_raises(banded):
    """A storage dtype the port does not take (fp16; bf16 and the two fp8
    formats are ported) raises, naming every supported one."""
    _, _, tp, bt = banded
    with pytest.raises(ValueError, match="store_dtype.*float8_e4m3fn"):
        tbtd.btd_factor(tp, bt, store_dtype="float16")


# -- K6's plain version --------------------------------------------------------

SWEEP_DTYPES = {
    "bf16-f64": (torch.bfloat16, torch.float64),
    "bf16-f32": (torch.bfloat16, torch.float32),
    "f64-f64": (torch.float64, torch.float64),
    "f32-f32": (torch.float32, torch.float32),
}


def _numpy_sweep(A, g, reverse, factor, vector):
    """The two recurrences as a numpy loop: the carried vector cast to the
    factor type (bf16 through f32), products summed in f32 for bf16
    factors, the result cast back before the subtraction."""
    n, bt = g.shape
    out = np.empty_like(g)
    carry = np.zeros(bt, dtype=g.dtype)
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        if factor == torch.bfloat16:
            xc = carry.astype(np.float32).astype(ml_dtypes.bfloat16)
            prod = (A[i].astype(np.float32) @ xc.astype(np.float32)).astype(g.dtype)
        else:
            prod = A[i] @ carry
        carry = g[i] - prod
        out[i] = carry
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtypes", list(SWEEP_DTYPES), ids=list(SWEEP_DTYPES))
def test_sweep_reference_matches_numpy_loop(dtypes, reverse):
    """``ops.btd_sweep`` on CPU tensors (its plain version, no launch)
    against a numpy loop of the recurrence, 9 row blocks of 16, the
    factors scaled so that the sweep contracts (as the Schur-complement
    products do): 1e-13 of max|y| in f64, 1e-5 where the products are f32
    sums (summed in another order, and the carried bf16 casts follow)."""
    factor, vector = SWEEP_DTYPES[dtypes]
    rng = np.random.default_rng(3)
    n, bt = 9, 16
    A64 = rng.standard_normal((n, bt, bt)) / bt
    g64 = rng.standard_normal((n, bt))
    A = torch.as_tensor(A64).to(factor)
    g = torch.as_tensor(g64).to(vector)
    A_np = A.numpy() if factor != torch.bfloat16 else np.asarray(
        A.float().numpy()).astype(ml_dtypes.bfloat16)
    ref = _numpy_sweep(A_np, g.numpy(), reverse, factor, vector)
    before = dict(ops.LAUNCHES)
    y = ops.btd_sweep(A, g, reverse=reverse)
    assert ops.LAUNCHES == before
    assert y.dtype == vector and tuple(y.shape) == (n, bt)
    rtol = 1e-13 if (factor, vector) == (torch.float64, torch.float64) else 1e-5
    _rel_close(y.numpy(), ref, rtol, dtypes)
    # the row check a kernel is held to: the plain sweep is its own fixed
    # point, within the dot-product order bound
    # (and one rounding of the subtraction)
    row_ref, bound = ops.btd_sweep_rows_reference(A, g, y, reverse)
    eps = torch.finfo(vector).eps
    assert bool(((y - row_ref).abs() <= bound + eps * row_ref.abs()).all())


# -- trajectories --------------------------------------------------------------


def _trajectories(models, params, n_steps, dt=5e-5):
    """(JAX trajectory, infos), (port trajectory, infos) from rest; the
    port on the banded cell pass, the JAX package on its plain one."""
    jm, tm = models
    times = dt * np.arange(n_steps + 1)
    _, jtraj, jinfos = jforward.integrate_pure(
        jm, *jax_inputs(jm), times, {**params, "assembly": "plain"})
    before = dict(ops.LAUNCHES)
    _, ttraj, tinfos = tforward.integrate_pure(
        tm, *port_inputs(tm), times, {**params, "assembly": "banded"})
    assert ops.LAUNCHES == before  # CPU tensors: the plain versions
    return ({k: np.asarray(v) for k, v in jtraj.items()}, jinfos,
            to_numpy(ttraj), tinfos)


def test_btd_trajectory_matches_jax(models):
    """24 steps at dt = 5e-5 with the factors refreshed every 8 steps, as
    tests/test_bsb.py:276-282 runs the JAX package: rtol 1e-9 per entry
    (atol 1e-10 of the field's max; the acceleration amplifies roundoff in
    u by 4/dt^2) and the same Newton counts."""
    jtraj, jinfos, ttraj, tinfos = _trajectories(
        models, {"linear_solver": "btd", "jacobian_refresh_steps": 8}, 24)
    for k in ("u", "v", "a", "q", "p"):
        ref = jtraj[k]
        np.testing.assert_allclose(ttraj[k], ref, rtol=1e-9,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=k)
    np.testing.assert_array_equal(tinfos.num_iter.numpy(),
                                  np.asarray(jinfos.num_iter))


@pytest.fixture(scope="module")
def production_small(models):
    return _trajectories(models, PROD_SMALL, 20)


def test_production_settings_trajectory_matches_jax(production_small):
    """The tail-free fixed-3 chord on bf16 factors (refresh 8 over 20
    steps): each field within 10x its measured port-vs-JAX difference
    (``PROD_SMALL_DIFF``), three Newton iterations every step."""
    jtraj, jinfos, ttraj, tinfos = production_small
    for k, diff in PROD_SMALL_DIFF.items():
        _rel_close(ttraj[k], jtraj[k], 10 * diff, k)
    assert (tinfos.num_iter.numpy() == 3).all()
    np.testing.assert_array_equal(tinfos.num_iter.numpy(),
                                  np.asarray(jinfos.num_iter))


def test_production_settings_traj_err(models, production_small):
    """The reference's gate (bench.py:454-473) on the small run:
    max|u_prod - u_exact| / max|u_exact| <= 5e-7 of the final displacement
    against the exact-Jacobian run of the same settings."""
    _, tm = models
    _, _, ttraj, _ = production_small
    fin, _, _ = tforward.integrate_pure(
        tm, *port_inputs(tm), 5e-5 * np.arange(21),
        {**EXACT_SMALL, "assembly": "banded"})
    u_exact = fin["u"].numpy()
    traj_err = np.abs(ttraj["u"][-1] - u_exact).max() / np.abs(u_exact).max()
    assert traj_err <= 5e-7


def test_btd_model_builds_no_dinv_or_dense_plan(monkeypatch):
    """A btd run builds the block-banded plan, never the block-Jacobi
    inverse (a Krylov preconditioner) nor the dense Jacobian's plan."""

    def no_dinv(self, dim):
        raise AssertionError("block_diag_inverse called on the btd path")

    monkeypatch.setattr(tassembly.EBEOperator, "block_diag_inverse", no_dinv)
    tm = port_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    tforward.integrate_pure(tm, *port_inputs(tm), 5e-5 * np.arange(5),
                            {"linear_solver": "btd",
                             "jacobian_refresh_steps": 2})
    assert tm.solid._jac_plan is None
    assert tm.solid._bsb is not None
