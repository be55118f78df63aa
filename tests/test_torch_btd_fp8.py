"""
fp8-stored block-Thomas factors in the port (``btd_store_dtype`` /
``btd_offdiag_dtype`` 'float8_e4m3fn' or 'float8_e5m2') against the JAX
package on the CPU, on the block-banded Jacobian of
``tests/test_torch_btd.py`` (the RCM-renumbered ``vocal_fold_mesh(10, 5)``,
KelvinVoigtWEpithelium + BernoulliAreaRatioSep, at rest under 500 Ba, b =
128; the JAX package factors the same blocks): the solve-error gates of
``tests/test_bsb.py:225-265``, the clamp and rounding of the cast entry
for entry against the JAX package's ``btd_factor``, and the plain version
of the sweep kernel K6 / K6T with fp8 factors (the vector cast to bf16,
never to fp8).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu.solvers import btd as jbtd
from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.solvers import bsb as tbsb
from vf_fem_tpu_torch.solvers import btd as tbtd

from port_fixtures import bare_plan, port_vf_model

FP8 = {"float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn, 0.3),
       "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2, 0.1)}


@pytest.fixture(scope="module")
def banded():
    """(JAX plan, JAX blocks, port plan, port blocks, dense A): the port's
    Jacobian, and the same blocks and plan shape in the JAX package's
    types, so that both packages factor the same blocks."""
    tm = port_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
    solid = tm.solid
    host = ({k: np.zeros(solid.ndof) for k in ("u", "v", "a")},
            {"p1": np.full(solid.nvert, 500.0)},
            {k: np.asarray(tm.prop[k]) for k in tm._solid_prop_keys})
    s0, c, p = ({k: torch.as_tensor(v) for k, v in d.items()} for d in host)
    op = solid.jac_u_ebe(s0["u"], s0, c, p, 1e-4)
    tp, fill = solid.bsb_plan()
    bt = tbsb.bsb_fill(tp, fill, [op.J_cells, op.J_facets])
    jp = bare_plan(jbsb.BSBPlan, tp.h, tp.nblk, tp.ndof, tp.b)
    return jp, jnp.asarray(bt.numpy()), tp, bt, _dense(tp, bt.numpy())


def _dense(plan, B):
    """The Jacobian as a dense (ndof, ndof) array, from its band storage."""
    b, h, nb, nblk = plan.b, plan.h, plan.nb, plan.nblk
    A = np.zeros((nblk * b, nblk * b))
    for n in range(nblk):
        for m in range(nb):
            col = n + m - h
            if 0 <= col < nblk:
                A[n * b:(n + 1) * b, col * b:(col + 1) * b] = B[n, m]
    return A[: plan.ndof, : plan.ndof]


def _solve(tp, fac, r, transpose=False):
    solve = tbtd.btd_solve_t if transpose else tbtd.btd_solve
    return solve(tp, fac, torch.as_tensor(r)).numpy()


def _rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("store", list(FP8))
def test_fp8_solve_gates(banded, store):
    """tests/test_bsb.py:236-256: finite clamped factors, the solve within
    0.3 (e4m3) / 0.1 (e5m2) of the dense solve, one refinement step at
    least halves the error, and the transposed solve on the same factors
    meets the same gate."""
    _, _, tp, bt, A = banded
    r = np.random.default_rng(0).standard_normal(tp.ndof)
    xr, xt_ref = np.linalg.solve(A, r), np.linalg.solve(A.T, r)
    tdt, _, tol0 = FP8[store]
    fac = tbtd.btd_factor(tp, bt, store_dtype=store)
    assert all(t.dtype == tdt for t in fac[:3])
    assert bool(torch.isfinite(fac.Sinv.float()).all())
    x8 = _solve(tp, fac, r)
    rel8 = _rel(x8, xr)
    assert rel8 < tol0, rel8
    x8b = x8 + _solve(tp, fac, r - A @ x8)
    assert _rel(x8b, xr) < 0.5 * rel8
    assert _rel(_solve(tp, fac, r, transpose=True), xt_ref) < tol0


def test_bf16_sinv_with_e4m3_offdiag(banded):
    """tests/test_bsb.py:258-265: bf16 Sinv with e4m3 V/W (the sweeps'
    arrays) solves within 10x the all-bf16 error."""
    _, _, tp, bt, A = banded
    r = np.random.default_rng(0).standard_normal(tp.ndof)
    xr = np.linalg.solve(A, r)
    rel0 = _rel(_solve(tp, tbtd.btd_factor(tp, bt, store_dtype="bfloat16"), r), xr)
    facm = tbtd.btd_factor(tp, bt, store_dtype="bfloat16", offdiag_dtype="float8_e4m3fn")
    assert facm.Sinv.dtype == torch.bfloat16
    assert facm.V.dtype == facm.W.dtype == torch.float8_e4m3fn
    assert _rel(_solve(tp, facm, r), xr) < 10 * max(rel0, 1e-4)


@pytest.mark.parametrize("store", list(FP8))
def test_fp8_cast_matches_jax(banded, store):
    """The clamp and the rounding of the fp8 cast, both packages factoring
    the same blocks: the port's ``store_cast`` of the JAX package's f64
    factors equals the JAX package's fp8 factors bit for bit
    (out-of-range entries saturate at the format's largest finite value);
    the port's own fp8 factors equal them entry for entry after both are
    cast to f32, except where the two packages' f64 factors straddle a
    rounding boundary (one fp8 step, in fewer than 1e-4 of the
    entries)."""
    jp, bj, tp, bt, _ = banded
    _, ndt, _ = FP8[store]
    f64 = jbtd.btd_factor(jp, bj)
    f8 = jbtd.btd_factor(jp, bj, store_dtype=store)
    mine = tbtd.btd_factor(tp, bt, store_dtype=store)
    for k in ("Sinv", "V", "W"):
        ref = np.asarray(getattr(f8, k)).astype(np.float32)
        cast = tbtd.store_cast(torch.as_tensor(np.asarray(getattr(f64, k))), store)
        np.testing.assert_array_equal(cast.float().numpy(), ref, err_msg=k)
        own = getattr(mine, k).float().numpy()
        off = own != ref
        step = np.abs(ref.astype(ndt).view(np.uint8).astype(np.int16)
                      - own.astype(ndt).view(np.uint8).astype(np.int16))
        assert off.mean() < 1e-4 and (step[off] <= 1).all(), (k, int(off.sum()))
    big = torch.tensor([1e6, -1e6, 3.0], dtype=torch.float64)
    fmax = tbtd.FP8_MAX[FP8[store][0]]
    assert tbtd.store_cast(big, store).float().tolist() == [fmax, -fmax, 3.0]


def test_unsupported_dtypes_raise(banded):
    """A dtype the port does not store or factor in raises, naming every
    supported one."""
    _, _, tp, bt, _ = banded
    with pytest.raises(ValueError, match="float8_e5m2"):
        tbtd.btd_factor(tp, bt, offdiag_dtype="float16")
    with pytest.raises(ValueError, match="float32"):
        tbtd.btd_factor(tp, bt, factor_dtype="bfloat16")


def _numpy_fp8_sweep(A8, g, reverse):
    """The recurrence as a numpy loop with the JAX package's rule for an
    fp8 block: the block to f32 (exact), the carried vector to bf16
    (through f32, as torch rounds), f32 products and sums, the result cast
    back before the subtraction."""
    out = np.empty_like(g)
    carry = np.zeros(g.shape[1], dtype=g.dtype)
    for i in (range(len(g) - 1, -1, -1) if reverse else range(len(g))):
        xc = carry.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)
        carry = g[i] - (A8[i].astype(np.float32) @ xc).astype(g.dtype)
        out[i] = carry
    return out


@pytest.mark.parametrize("vector", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("store", list(FP8))
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_fp8_sweep_reference(store, vector, reverse):
    """K6's plain version with fp8 factors (no launch on CPU tensors)
    against a numpy loop of the rule, 9 row blocks of 16, contracting
    factors: 1e-5 of max|y|; its transposed sweep K6T likewise; the row
    check a kernel is held to passes on the plain sweep itself."""
    tdt, ndt, _ = FP8[store]
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((9, 16, 16)) / 16).to(tdt)
    g = torch.as_tensor(rng.standard_normal((9, 16))).to(vector)
    A8 = A.view(torch.uint8).numpy().view(ndt)
    before = dict(ops.LAUNCHES)
    y = ops.btd_sweep(A, g, reverse=reverse)
    assert ops.LAUNCHES == before and y.dtype == vector
    ref = _numpy_fp8_sweep(A8, g.numpy(), reverse)
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    row_ref, bound = ops.btd_sweep_rows_reference(A, g, y, reverse)
    assert ((y - row_ref).abs() <= 1e-13 * row_ref.abs() + bound).all()
    # K6T's plain version: the shifted, transposed blocks of the same rule
    yt = ops.btd_sweep_t(A, g, reverse=reverse)
    shifted = np.zeros_like(A8)
    if reverse:
        shifted[:-1] = A8[1:].transpose(0, 2, 1)
    else:
        shifted[1:] = A8[:-1].transpose(0, 2, 1)
    ref_t = _numpy_t(shifted, g.numpy(), reverse)
    assert np.abs(yt.numpy() - ref_t).max() <= 1e-5 * np.abs(ref_t).max()


def _numpy_t(shifted, g, reverse):
    """K6T's sweep ``y_i = g_i - A'_i y_{i-1}`` (``y_0 = g_0``) on the
    shifted, transposed blocks ``A'`` by :func:`_numpy_fp8_sweep`'s rule:
    its first row block reads no block."""
    return _numpy_fp8_sweep(shifted, g, reverse)
