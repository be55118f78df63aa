"""
The port's matrix-free Newton-Krylov path against the JAX package on the
CPU in f64, on the RCM-renumbered ``vocal_fold_mesh(10, 5)`` of
``tests/test_bsb.py`` with KelvinVoigtWEpithelium + BernoulliAreaRatioSep:
the RCM permutation, the block-banded plan and fill, the element-by-element
operator and its block-Jacobi inverse, BiCGStab and PCG, and whole
``integrate_pure`` trajectories with ``linear_solver='bsb'`` and ``'cg'``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu import mesh as jmesh
from vf_fem_tpu.mesh import reorder as jreorder
from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu.solvers import linalg as jlinalg
from vf_fem_tpu_torch import forward as tforward
from vf_fem_tpu_torch import mesh as tmesh
from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.convert import to_numpy
from vf_fem_tpu_torch.fem import assembly as tassembly
from vf_fem_tpu_torch.mesh import reorder as treorder
from vf_fem_tpu_torch.solvers import bsb as tbsb
from vf_fem_tpu_torch.solvers import linalg as tlinalg

from port_fixtures import (
    jax_inputs, jax_vf_model, port_inputs, port_vf_model, solid_args,
)

NX, NY = 10, 5
DT = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jax_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    tm = port_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
    return jm, tm


@pytest.fixture(scope="module")
def operators(models):
    """The element-by-element Jacobian at rest under 500 Ba, both
    packages."""
    jm, tm = models
    (s0j, cj, pj), (s0t, ct, pt) = solid_args(jm, 500.0)
    opj = jm.solid.jac_u_ebe(s0j["u"], s0j, cj, pj, DT)
    opt = tm.solid.jac_u_ebe(s0t["u"], s0t, ct, pt, DT)
    return opj, opt


def _close(a, b, rtol, err_msg=""):
    """rtol per entry, plus an atol of 1e-15 x the field's max for entries
    at the rounding-noise level."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=1e-15 * np.abs(b).max(), err_msg=err_msg)


def test_rcm_matches():
    jm0 = jmesh.vocal_fold_mesh(NX, NY)
    tm0 = tmesh.vocal_fold_mesh(NX, NY)
    np.testing.assert_array_equal(treorder.rcm_permutation(tm0),
                                  jreorder.rcm_permutation(jm0))
    j2, t2 = jreorder.rcm_mesh(jm0), treorder.rcm_mesh(tm0)
    np.testing.assert_array_equal(t2.coords, j2.coords)
    np.testing.assert_array_equal(t2.cells, j2.cells)
    for d in (0, 1, 2):
        assert t2.subdomains[d] == j2.subdomains[d]
    marked = lambda m: {  # noqa: E731
        (tuple(sorted(m.facets[i].tolist())), int(m.mesh_functions[1][i]))
        for i in np.nonzero(m.mesh_functions[1])[0]
    }
    assert marked(t2) == marked(j2)
    np.testing.assert_array_equal(t2.mesh_functions[0], j2.mesh_functions[0])
    np.testing.assert_array_equal(t2.mesh_functions[2], j2.mesh_functions[2])


def test_load_rejects_unknown_reorder():
    with pytest.raises(ValueError, match="reorder"):
        port_vf_model(nx=4, ny=2, reorder="metis")


def test_bsb_plan_matches(models):
    jm, tm = models
    jp, tp = jm.solid._get_bsb_plan(), tm.solid.bsb_plan()[0]
    assert tp._fields == jp._fields
    for f in jp._fields:
        a, b = getattr(tp, f), getattr(jp, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_bsb_fill_matches(models, operators):
    jm, tm = models
    opj, opt = operators
    _close(opt.J_cells, opj.J_cells, 1e-13, "J_cells")
    _close(opt.J_facets, opj.J_facets, 1e-13, "J_facets")
    bj = jbsb.bsb_fill(jm.solid._get_bsb_plan(), [opj.J_cells, opj.J_facets])
    plan, fill = tm.solid.bsb_plan()
    bt = tbsb.bsb_fill(plan, fill, [opt.J_cells, opt.J_facets])
    assert tuple(bt.shape) == (plan.nblk, plan.nb, plan.b, plan.b)
    _close(bt, bj, 1e-13, "blocks")


def test_ebe_matvec_and_block_jacobi_match(operators):
    opj, opt = operators
    x = np.random.default_rng(0).standard_normal(opt.plans.dofs.n_out)
    _close(opt.matvec(torch.as_tensor(x)), opj.matvec(jnp.asarray(x)), 1e-12,
           "matvec")
    _close(opt.block_diag_inverse(2), opj.block_diag_inverse(2), 1e-12, "Dinv")


def _symmetric(op, lib):
    """The operator with symmetrized element blocks and no Dirichlet rows:
    symmetric positive definite (mass-dominated), as PCG needs.  (Identity
    Dirichlet rows alone make the Newton Jacobian nonsymmetric.)"""
    sym = lambda J: (J + lib.swapaxes(J, -1, -2)) / 2  # noqa: E731
    return op._replace(J_cells=sym(op.J_cells), J_facets=sym(op.J_facets),
                       bc_dofs=op.bc_dofs[:0])


@pytest.mark.parametrize("operator", ["ebe", "bsb"])
@pytest.mark.parametrize("krylov", ["bicgstab", "pcg"])
def test_krylov_solvers_match(models, operators, operator, krylov):
    """Same operator, right-hand side and block-Jacobi preconditioner: the
    same iteration count and solution.  BiCGStab solves the Newton
    Jacobian; PCG its symmetric positive definite counterpart."""
    jm, tm = models
    opj, opt = operators
    if krylov == "pcg":
        opj, opt = _symmetric(opj, jnp), _symmetric(opt, torch)
    Dj, Dt = opj.block_diag_inverse(2), opt.block_diag_inverse(2)
    if operator == "bsb":
        jp, (plan, fill) = jm.solid._get_bsb_plan(), tm.solid.bsb_plan()
        if krylov == "pcg":  # plans without Dirichlet rows
            jp = jbsb.plan_bsb([jm.solid._cell_dofs, jm.solid._facet_cell_dofs],
                               jp.ndof, np.zeros(0, np.int32))
            plan = tbsb.plan_bsb(tm.solid._elem_dofs, jp.ndof,
                                 np.zeros(0, np.int32))
            fill = tbsb.fill_plan(plan, "cpu")
        bj = jbsb.bsb_fill(jp, [opj.J_cells, opj.J_facets])
        mvj = lambda v: jbsb.bsb_matvec(jp, bj, v)  # noqa: E731
        bt = tbsb.bsb_fill(plan, fill, [opt.J_cells, opt.J_facets])
        mvt = lambda v: ops.bsb_matvec(plan, bt, v)  # noqa: E731
    else:
        mvj, mvt = opj.matvec, opt.matvec
    b = np.random.default_rng(1).standard_normal(tm.solid.ndof) * 1e3
    prej = lambda v: jnp.einsum(  # noqa: E731
        "nij,nj->ni", Dj, v.reshape(-1, 2)).reshape(-1)
    pret = lambda v: tassembly.block_jacobi_apply(Dt, v)  # noqa: E731
    jsolve = getattr(jlinalg, krylov)
    tsolve = getattr(tlinalg, krylov)
    rj = jsolve(mvj, jnp.asarray(b), precond=prej, tol=1e-10, max_iter=1000)
    rt = tsolve(mvt, torch.as_tensor(b), precond=pret, tol=1e-10,
                max_iter=1000)
    assert 0 < rt.n_iter < 1000
    assert rt.n_iter == int(rj.n_iter)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rj.x)).max())


@pytest.mark.parametrize(
    "linear_solver,extra,n_steps",
    [("bsb", {"jacobian_refresh_steps": 8}, 30),
     ("cg", {"jacobian_refresh_steps": 8}, 30),
     ("bsb", {"jacobian_update": "every_iteration"}, 8)],
    ids=["bsb", "cg", "bsb-every-iteration"],
)
def test_krylov_trajectory_matches_jax(models, linear_solver, extra, n_steps):
    """30 steps at dt = 5e-5 with the Krylov factors refreshed every 8
    steps, as tests/test_bsb.py runs the JAX package (and a short run that
    re-assembles the factors every Newton iteration); the port uses the
    banded cell pass, the JAX package its plain one."""
    jm, tm = models
    params = {"linear_solver": linear_solver, "krylov_tolerance": 1e-10,
              **extra}
    times = 5e-5 * np.arange(n_steps + 1)
    js0, jcs, jprop = jax_inputs(jm)
    jfin, jtraj, jinfos = jforward.integrate_pure(
        jm, js0, jcs, jprop, times, {**params, "assembly": "plain"}
    )
    ts0, tcs, tprop = port_inputs(tm)
    tm.solid.krylov_counts.update(solves=0, iterations=0)
    before = dict(ops.LAUNCHES)
    tfin, ttraj, tinfos = tforward.integrate_pure(
        tm, ts0, tcs, tprop, times, {**params, "assembly": "banded"}
    )
    assert ops.LAUNCHES == before  # CPU tensors: the plain versions
    counts = tm.solid.krylov_counts
    assert counts["solves"] == int(tinfos.num_iter.sum())  # one per Newton step
    assert counts["iterations"] > counts["solves"]
    ttraj = to_numpy(ttraj)
    for k in ("u", "v", "a", "q", "p"):
        ref = np.asarray(jtraj[k])
        np.testing.assert_allclose(ttraj[k], ref, rtol=1e-9,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)
    np.testing.assert_array_equal(tinfos.num_iter.numpy(),
                                  np.asarray(jinfos.num_iter))


def test_krylov_model_builds_no_dense_plan():
    """A Krylov run never builds the dense Jacobian's scatter plan (an
    ndof^2-sized target at large meshes); a dense run builds it."""
    for ls, built in (("bsb", False), ("cg", False), ("dense", True)):
        tm = port_vf_model("KelvinVoigtWEpithelium", NX, NY, reorder="rcm")
        ts0, tcs, tprop = port_inputs(tm)
        tforward.integrate_pure(tm, ts0, tcs, tprop, 5e-5 * np.arange(3),
                                {"linear_solver": ls})
        assert (tm.solid._jac_plan is not None) == built, ls
        assert (tm.solid._bsb is not None) == (ls == "bsb"), ls


@pytest.mark.parametrize("option", [{"linear_solver": "pcr"},
                                    {"linear_solver": "bsb", "krylov": "gmres"}])
def test_unported_options_raise(models, option):
    _, tm = models
    ts0, tcs, tprop = port_inputs(tm)
    with pytest.raises(NotImplementedError):
        tforward.integrate_pure(tm, ts0, tcs, tprop, 5e-5 * np.arange(3),
                                option)
