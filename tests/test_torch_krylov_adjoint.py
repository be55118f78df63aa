"""
The adjoints of the port's matrix-free Krylov solvers against the JAX
package on the CPU in f64, on the RCM-renumbered ``vocal_fold_mesh(10, 5)``
with KelvinVoigtWEpithelium + BernoulliAreaRatioSep (the model of
``tests/test_torch_krylov.py``):

- the transposed operators: ``ops.ebe_matvec_t`` (K3T's plain version),
  ``EBEOperator.matvec_transpose`` and ``ops.bsb_matvec_t`` (K4T's plain
  version) against the JAX package's, rtol 1e-13, and each against its
  forward operator by ``<y, A x> = <A^T y, x>``;
- K4T's transposed pattern (``solvers.bsb.matvec_pattern_t``) and its
  emulated summation order (``tests/bsb_emulation.py``);
- the transposed Krylov solve (BiCGStab on ``A^T`` whatever ``krylov``
  says);
- ``adjoint.integrate_grad`` with ``linear_solver='cg'`` and ``'bsb'``
  (Krylov tolerance 1e-12, a fresh transposed solve each step) against the
  JAX package's, each key within rtol 1e-7 of its largest entry.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import adjoint as jadjoint
from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu_torch import adjoint, ops
from vf_fem_tpu_torch.models.transient import KrylovFactors
from vf_fem_tpu_torch.ops import kernels
from vf_fem_tpu_torch.solvers import bsb as tbsb

from bsb_emulation import emulate_bsb_matvec_t
from port_fixtures import jax_vf_model, port_inputs, port_vf_model, solid_args
from test_torch_adjoint import _functional, _jax_functional, assert_grads_close

NX, NY = 10, 5
DT = 1e-4
RTOL = 1e-13


@pytest.fixture(scope="module")
def models():
    jm = jax_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    tm = port_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    return jm, tm


@pytest.fixture(scope="module")
def operators(models):
    """The element-by-element Jacobian at rest under 500 Ba and its
    block-banded fill, both packages."""
    jm, tm = models
    (s0j, cj, pj), (s0t, ct, pt) = solid_args(jm, 500.0)
    opj = jm.solid.jac_u_ebe(s0j["u"], s0j, cj, pj, DT)
    opt = tm.solid.jac_u_ebe(s0t["u"], s0t, ct, pt, DT)
    jp = jm.solid._get_bsb_plan()
    plan, fill = tm.solid.bsb_plan()
    bj = jbsb.bsb_fill(jp, [opj.J_cells, opj.J_facets])
    bt = tbsb.bsb_fill(plan, fill, [opt.J_cells, opt.J_facets])
    return opj, opt, jp, bj, plan, fill, bt


def _close(a, b, rtol=RTOL, err_msg=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=1e-15 * np.abs(b).max(), err_msg=err_msg)


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("part", ["cells", "facets"])
def test_ebe_matvec_t_matches_jax(operators, part):
    """K3T's plain version against the JAX package's transposed element
    product (``assembly.py:259``) on the model's element blocks."""
    opj, opt = operators[:2]
    J, d = (opt.J_cells, opt.cell_dofs) if part == "cells" else (opt.J_facets, opt.facet_dofs)
    Jj, dj = (opj.J_cells, opj.cell_dofs) if part == "cells" else (opj.J_facets, opj.facet_dofs)
    x = np.random.default_rng(0).standard_normal(opt.plans.dofs.n_out)
    before = dict(ops.LAUNCHES)
    y = ops.ebe_matvec_t(J, torch.as_tensor(x), d)
    assert ops.LAUNCHES == before  # CPU tensors: the plain version
    _close(y, jnp.einsum("eji,ej->ei", Jj, jnp.asarray(x)[dj]), err_msg=part)
    # the transpose of K3's plain version, element by element: e[k] of
    # element k read through the identity dof map
    e = torch.as_tensor(np.random.default_rng(1).standard_normal(y.numel()))
    own = torch.arange(y.numel()).reshape(y.shape)
    lhs = (e[own] * ops.ebe_matvec(J, torch.as_tensor(x), d)).sum(1)
    rhs = (ops.ebe_matvec_t(J, e, own) * torch.as_tensor(x)[d]).sum(1)
    _close(lhs, rhs, 1e-12)


def test_matvec_transpose_matches_jax(operators):
    """``EBEOperator.matvec_transpose`` (Dirichlet columns included) against
    the JAX package's, and ``<y, A x> = <A^T y, x>``."""
    opj, opt = operators[:2]
    x, y = _vectors(opt.plans.dofs.n_out, 2)
    out = opt.matvec_transpose(torch.as_tensor(y))
    _close(out, opj.matvec_transpose(jnp.asarray(y)))
    lhs = float(np.dot(y, opt.matvec(torch.as_tensor(x)).numpy()))
    rhs = float(np.dot(out.numpy(), x))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    # the input is left as it was (the Dirichlet entries are zeroed in a copy)
    yt = torch.as_tensor(y)
    opt.matvec_transpose(yt)
    assert np.array_equal(yt.numpy(), y)


def test_bsb_matvec_t_matches_jax(operators):
    """K4T's plain version against the JAX package's ``bsb_matvec_t``, and
    against K4's by ``<y, A x> = <A^T y, x>``; and the element-by-element
    transpose gives the same ``A^T y``."""
    _, opt, jp, bj, plan, _, bt = operators
    x, y = _vectors(plan.ndof, 3)
    out = ops.bsb_matvec_t(plan, bt, torch.as_tensor(y))
    _close(out, jbsb.bsb_matvec_t(jp, bj, jnp.asarray(y)))
    lhs = float(np.dot(y, ops.bsb_matvec(plan, bt, torch.as_tensor(x)).numpy()))
    np.testing.assert_allclose(lhs, float(np.dot(out.numpy(), x)), rtol=1e-12)
    _close(out, opt.matvec_transpose(torch.as_tensor(y)), 1e-12)


def _entries(plan, pattern, by_column):
    """(flat band index, row, column) of every pattern entry, in order."""
    b, nb = plan.b, plan.nb
    ptr = np.asarray(pattern.ptr, dtype=np.int64)
    off = np.asarray(pattern.off, dtype=np.int64)
    major = np.repeat(np.arange(plan.ndof), np.diff(ptr))
    if by_column:
        cols = major
        n = cols // b - off // (b * b) + plan.h
        rows = n * b + (off // b) % b
    else:
        rows = major
        n = rows // b
        cols = (n + off // (b * b) - plan.h) * b + off % b
    return n * nb * b * b + off, rows, cols


def test_pattern_t_is_the_transposed_pattern(operators):
    """K4T's pattern holds K4's entries, CSR by column with rows ascending;
    the row each offset gives with its column is that entry's row; the
    device fill carries it as int32 tensors."""
    plan, fill = operators[4:6]
    pt = tbsb.matvec_pattern_t(plan)
    for a, t in zip(pt, fill.pattern_t):
        assert a.dtype == np.int32 and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), a)
    flat_r, rows_r, cols_r = _entries(plan, tbsb.matvec_pattern(plan), False)
    flat_c, rows_c, cols_c = _entries(plan, pt, True)
    np.testing.assert_array_equal(np.sort(flat_c), np.sort(flat_r))
    order = np.lexsort((rows_r, cols_r))
    np.testing.assert_array_equal(flat_c, flat_r[order])
    np.testing.assert_array_equal(rows_c, rows_r[order])
    same_col = cols_c[1:] == cols_c[:-1]
    assert (rows_c[1:][same_col] > rows_c[:-1][same_col]).all()
    assert (np.diff(pt.ptr) >= 1).all()  # every column has its diagonal at least


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_emulated_t_order_matches_plain(operators, dtype):
    """K4T's summation order (emulated: each column's entries over
    ``kernels.BSB_LANES`` lanes in K4's order, lane sums in CSR order then
    the xor tree, each product and sum rounded once) against the plain
    version within rtol 1e-13 / 1e-6 (f64 / f32) plus the dot-product order
    bound."""
    plan, fill, bt = operators[4:]
    blocks = bt.numpy().astype(dtype)
    x = np.random.default_rng(4).standard_normal(plan.ndof).astype(dtype)
    y = emulate_bsb_matvec_t(plan, fill.pattern_t, blocks, x, kernels.BSB_LANES)
    assert y.dtype == dtype and y.shape == (plan.ndof,)
    ref = ops.bsb_matvec_t_reference(plan, torch.from_numpy(blocks), torch.from_numpy(x))
    bound = ops.dot_order_bound(ops.bsb_matvec_t_reference(
        plan, torch.from_numpy(np.abs(blocks)), torch.from_numpy(np.abs(x))),
        plan.nb * plan.b).numpy()
    rtol = 1e-13 if dtype == np.float64 else 1e-6
    assert (np.abs(y - ref.numpy()) <= rtol * np.abs(ref.numpy()) + bound).all()


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_emulated_t_order_on_a_random_fill(operators, lanes):
    """The same on a fill from random element Jacobians (f64), for 1, 2 and
    4 lanes a column: the lanes change only the order of each column's sum,
    so every count stays within the bound, and one lane is the column's
    entries added one after another in CSR order."""
    plan, fill = operators[4:6]
    rng = np.random.default_rng(lanes)
    blocks = tbsb.bsb_fill(plan, fill, [torch.as_tensor(
        rng.standard_normal(plan.tgt_idx.size))]).numpy()
    x = rng.standard_normal(plan.ndof)
    y = emulate_bsb_matvec_t(plan, fill.pattern_t, blocks, x, lanes)
    ref = ops.bsb_matvec_t_reference(plan, torch.from_numpy(blocks), torch.from_numpy(x))
    bound = ops.dot_order_bound(ops.bsb_matvec_t_reference(
        plan, torch.from_numpy(np.abs(blocks)), torch.from_numpy(np.abs(x))),
        plan.nb * plan.b).numpy()
    assert (np.abs(y - ref.numpy()) <= 1e-13 * np.abs(ref.numpy()) + bound).all()
    if lanes == 1:
        ptr = np.asarray(fill.pattern_t.ptr)
        c = int(np.argmax(np.diff(ptr)))  # the longest column
        off = np.asarray(fill.pattern_t.off)[ptr[c]:ptr[c + 1]]
        b = plan.b
        n = c // b - off // (b * b) + plan.h
        prods = blocks.reshape(plan.nblk, -1)[n, off] * x[n * b + (off // b) % b]
        acc = 0.0
        for p in prods:
            acc = acc + p
        assert y[c] == acc


@pytest.mark.parametrize("solver", ["cg", "bsb"])
def test_transposed_krylov_solve(models, operators, solver):
    """``iter_solve(transpose=True)`` solves ``A^T x = r`` with the
    transposed operator by BiCGStab, also where ``krylov='pcg'``."""
    _, tm = models
    opt, bt = operators[1], operators[6]
    fac = KrylovFactors(bt if solver == "bsb" else opt, opt.block_diag_inverse(2))
    r = torch.as_tensor(np.random.default_rng(6).standard_normal(tm.solid.ndof) * 1e3)
    for krylov in ("bicgstab", "pcg"):
        params = {"linear_solver": solver, "krylov": krylov, "krylov_tolerance": 1e-12}
        x = tm.solid.iter_solve(fac, r, params, transpose=True)
        res = opt.matvec_transpose(x) - r
        assert float(res.norm()) <= 1e-10 * float(r.norm()), krylov


@pytest.mark.parametrize("solver", ["cg", "bsb"])
def test_krylov_integrate_grad_matches_jax(models, solver):
    """Value+grad of ``tests/test_adjoint.py``'s functional over 5 steps at
    dt = 2e-5 with ``linear_solver`` 'cg' / 'bsb', Krylov tolerance 1e-12
    and refresh 1 (each step's factors and a fresh transposed BiCGStab solve
    at u1, in both packages): the value to 1e-10, every gradient key within
    rtol 1e-7 of its largest JAX entry.  (Replaces the test that the port's
    'cg' / 'bsb' backward raised, before K3T / K4T.)"""
    jm, tm = models
    times = 2e-5 * np.arange(6)
    params = {"linear_solver": solver, "krylov_tolerance": 1e-12,
              "krylov_max_iter": 2000, "jacobian_refresh_steps": 1}
    ini = jm.state0.copy()
    ini[:] = 0.0
    vj, gj = jadjoint.integrate_grad(jm, _jax_functional, ini, [jm.control], jm.prop,
                                     times, {**params, "assembly": "plain"})
    s0, _, prop = port_inputs(tm)
    tm.solid.adjoint_counts.update(solves=0, refine_iterations=0)
    tm.solid.krylov_counts.update(solves=0, iterations=0)
    vt, gt = adjoint.integrate_grad(tm, _functional, s0, [tm.control], prop, times,
                                    {**params, "assembly": "banded"})
    assert tm.solid.adjoint_counts == {"solves": 5, "refine_iterations": 0}
    assert abs(vt - vj) <= 1e-10 * abs(vj)
    assert_grads_close(gt, gj, 1e-7, vj)
