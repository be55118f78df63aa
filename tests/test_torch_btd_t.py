"""
The port's transposed solves of the gradient path against the JAX package
on the CPU in f64: the transposed block-Thomas solve ``btd_solve_t`` on the
JAX package's own factors (f64 and bf16 storage; its sweeps take the plain
version of kernel K6T here), the plain transposed sweep against a numpy
loop, and the equilibrated transposed dense solves.  The model and the two
block-banded plans (b = 128 and b = 8) are ``tests/test_torch_btd.py``'s.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu.solvers import btd as jbtd
from vf_fem_tpu.solvers import linalg as jlinalg
from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.convert import array_to_tensor
from vf_fem_tpu_torch.solvers import bsb as tbsb
from vf_fem_tpu_torch.solvers import btd as tbtd
from vf_fem_tpu_torch.solvers import linalg as tlinalg

from port_fixtures import jax_vf_model, port_vf_model, solid_args

NX, NY = 10, 5
DT = 1e-4
F32_U = 2.0 ** -24  # f32 unit roundoff


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
    bt = tbsb.bsb_fill(tp, tbsb.fill_plan(tp, "cpu"), [opt.J_cells, opt.J_facets])
    return jp, bj, tp, bt


def _rel_close(a, b, rtol, what=""):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max()
    assert err <= rtol * np.abs(b).max(), f"{what}: {err:.3e} of max {np.abs(b).max():.3e}"


@pytest.mark.parametrize("store", [None, "bfloat16"], ids=["f64", "bf16"])
def test_solve_t_on_jax_factors(banded, store):
    """``btd_solve_t`` of the port on the JAX package's own factors
    (converted by ``convert.array_to_tensor``) against the JAX package's
    ``btd_solve_t``: 1e-13 of max|x| with f64 factors; with bf16 factors
    (f32 sums in another order) within the f32 summation bound of one block
    row, 2 gamma_Bt(f32) max|x|, as ``btd_solve`` is held."""
    jp, bj, tp, bt = banded
    fj = jbtd.btd_factor(jp, bj, store_dtype=store)
    ft = tbtd.BTDFactors(*(array_to_tensor(x, "cpu") for x in fj))
    r = np.random.default_rng(3).standard_normal(tp.ndof)
    before = dict(ops.LAUNCHES)
    x = tbtd.btd_solve_t(tp, ft, torch.as_tensor(r))
    assert ops.LAUNCHES == before  # CPU tensors: the plain sweeps
    xj = np.asarray(jbtd.btd_solve_t(jp, fj, jnp.asarray(r)))
    Bt = ft.Sinv.shape[-1]
    rtol = 1e-13 if store is None else 2 * Bt * F32_U / (1 - Bt * F32_U)
    _rel_close(x, xj, rtol, f"x ({store})")


def test_solve_t_solves_the_transpose(banded):
    """With f64 factors, ``A^T x = r`` of the dense Jacobian to 1e-10 of
    max|r| (the block-Thomas factors' roundoff)."""
    _, _, tp, bt = banded
    n = tp.ndof
    A = np.zeros((n, n))
    b, h = tp.b, tp.h
    B = bt.numpy()
    for i in range(tp.nblk):
        for m in range(tp.nb):
            j = i + m - h
            if 0 <= j < tp.nblk:
                rows = slice(i * b, min((i + 1) * b, n))
                cols = slice(j * b, min((j + 1) * b, n))
                A[rows, cols] = B[i, m][: rows.stop - rows.start, : cols.stop - cols.start]
    r = np.random.default_rng(4).standard_normal(n)
    x = tbtd.btd_solve_t(tp, tbtd.btd_factor(tp, bt), torch.as_tensor(r)).numpy()
    _rel_close(A.T @ x, r, 1e-10, "A^T x")


def _numpy_sweep_t(A, g, reverse):
    """The transposed sweep in numpy, f64 throughout (A in f64)."""
    n = g.shape[0]
    out = np.empty_like(g)
    rows = list(range(n - 1, -1, -1) if reverse else range(n))
    carry = g[rows[0]]
    out[rows[0]] = carry
    for i in rows[1:]:
        carry = g[i] - A[i + 1 if reverse else i - 1].T @ carry
        out[i] = carry
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [1, 2, 7])
def test_sweep_t_reference_is_the_numpy_loop(n, reverse):
    """The plain version of K6T against a numpy loop: f64 factors to
    1e-14 of max|y|; bf16 factors (the vector rounded to bf16, products
    summed in f32) against the numpy loop on the same bf16 values
    (exactly representable in f64) within the f32 summation bound of one
    block row per row, 2 gamma_Bt(f32), and a row of A^T picks the right
    column."""
    rng = np.random.default_rng(n)
    bt = 16
    A = rng.standard_normal((n, bt, bt)) * (0.5 / bt ** 0.5)
    g = rng.standard_normal((n, bt))
    y = ops.btd_sweep_t_reference(torch.as_tensor(A), torch.as_tensor(g), reverse)
    _rel_close(y, _numpy_sweep_t(A, g, reverse), 1e-14, "f64")
    Ab = torch.as_tensor(A).to(torch.bfloat16)
    yb = ops.btd_sweep_t_reference(Ab, torch.as_tensor(g), reverse)
    ref = _numpy_sweep_t(Ab.double().numpy(), g, reverse)
    # the carried vector is rounded to bf16 in the kernel's rule: ~2^-8
    _rel_close(yb, ref, 2.0 ** -7, "bf16")
    # one nonzero entry: row i of the sweep picks column j of A_{i -/+ 1}^T
    if n >= 2:
        # forward: y_1 = g_1 - A_0^T y_0; reverse: x_{n-2} = g_{n-2} - A_{n-1}^T x_{n-1}
        blk, first, second = (n - 1, n - 1, n - 2) if reverse else (0, 0, 1)
        A1 = np.zeros((n, bt, bt))
        A1[blk, 3, 5] = 1.0
        g1 = np.zeros((n, bt))
        g1[first, 3] = 2.0
        y1 = ops.btd_sweep_t_reference(torch.as_tensor(A1), torch.as_tensor(g1), reverse)
        assert float(y1[second, 5]) == -2.0


def test_sweep_t_rows_reference_holds_the_plain_sweep():
    """Every row of the plain transposed sweep, recomputed from its own
    previous row (a batched product: another summation order), is within
    its bound on dot-product order; the first row is g's exactly."""
    rng = np.random.default_rng(9)
    A = torch.as_tensor(rng.standard_normal((5, 16, 16)) * 0.1)
    g = torch.as_tensor(rng.standard_normal((5, 16)))
    for fac in (A, A.to(torch.bfloat16)):
        for rev in (False, True):
            out = ops.btd_sweep_t_reference(fac, g, rev)
            ref, bound = ops.btd_sweep_t_rows_reference(fac, g, out, rev)
            assert bool(((ref - out).abs() <= bound).all())
            first = -1 if rev else 0
            assert torch.equal(ref[first], g[first]) and float(bound[first].max()) == 0.0
            assert float(bound.max()) > 0


def test_dense_solve_transpose_matches_jax():
    """The equilibrated transposed dense solve and the transposed
    application of carried dense factors against the JAX package's
    ``dense_solve_transpose`` (1e-13 of max|x|) and the dense transpose."""
    rng = np.random.default_rng(5)
    n = 40
    A = rng.standard_normal((n, n)) + np.diag(1e4 * (1 + rng.random(n)))
    b = rng.standard_normal(n)
    x = tlinalg.dense_solve_transpose(torch.as_tensor(A), torch.as_tensor(b))
    _rel_close(x, np.asarray(jlinalg.dense_solve_transpose(jnp.asarray(A), jnp.asarray(b))),
               1e-13, "dense_solve_transpose")
    _rel_close(A.T @ x.numpy(), b, 1e-13, "A^T x")
    fac = tlinalg.dense_factor(torch.as_tensor(A))
    y = tlinalg.dense_factor_solve_t(fac, torch.as_tensor(b))
    _rel_close(y, x, 1e-12, "dense_factor_solve_t")
