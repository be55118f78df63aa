"""
Mixed-precision factors in the port (``btd_factor_dtype='float32'``: f64
state and residuals, f32 block-Thomas / SPIKE factors and solves) against
the JAX package on the CPU: ``tests/test_refine.py:19-100`` (the
RCM-renumbered ``vocal_fold_mesh(10, 5)``, KelvinVoigt +
BernoulliSmoothMinSep, 24 steps) for 'btd' and 'spike' (4 partitions)
against the JAX package's dense f64 run, and the DOF-sharded loop of
``tests/test_ddstep.py:769-800`` (16 steps over 4 stacked shards) against
its f64 run.  The exact solves of a tangent keep the f32 factors
(``SolidModel._exact_solve``).
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu.load import load_fsi_model as jload_fsi
from vf_fem_tpu.mesh import vocal_fold_mesh as jvocal_fold_mesh
from vf_fem_tpu.mesh.reorder import rcm_mesh as jrcm_mesh
from vf_fem_tpu.residuals import fluid as jflr, solid as jslr
from vf_fem_tpu_torch import forward
from vf_fem_tpu_torch.parallel import ddstep

from port_fixtures import port_dd_model, port_inputs, set_dd_props

TIMES = 5e-5 * np.arange(25)
MIXED = {"btd_factor_dtype": "float32", "jacobian_refresh_steps": 8,
         "absolute_tolerance": 1e-8, "relative_tolerance": 1e-10}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixed():
    """The port's model and the JAX package's dense f64 trajectory."""
    mesh = jrcm_mesh(jvocal_fold_mesh(10, 5))
    jm = jload_fsi(mesh, jslr.KelvinVoigt, jflr.BernoulliSmoothMinSep, coupling="explicit")
    set_dd_props(jm.prop, jm.control, mesh.coords[:, 1].max())
    jm.set_prop(jm.prop)
    jm.set_control(jm.control)
    s0 = {k: np.zeros_like(np.asarray(v)) for k, v in jm.state0.sub_items()}
    _, traj, _ = jforward.integrate_pure(
        jm, s0, jforward._stack_controls(jm, [jm.control]), jm.prop_to_dict(jm.prop),
        TIMES, {"jacobian_refresh_steps": 1})
    return port_dd_model(10, 5), np.asarray(traj["u"])


def _check_mixed(traj, infos, ref_u):
    """tests/test_refine.py:_check_mixed: every step meets abs 1e-8 or rel
    1e-10, the trajectory lies within 1e-10 max|u| of the f64 reference,
    and u stays f64."""
    abs_err, rel_err = infos.abs_err.numpy(), infos.rel_err.numpy()
    assert np.all((abs_err < 1e-8) | (rel_err < 1e-10))
    u = traj["u"]
    assert u.dtype == torch.float64
    assert np.abs(u.numpy() - ref_u).max() < 1e-10 * max(np.abs(ref_u).max(), 1e-30)


@pytest.mark.parametrize("solver", [{"linear_solver": "btd"},
                                    {"linear_solver": "spike", "spike_partitions": 4}],
                         ids=["btd", "spike"])
def test_f32_factors_reach_f64_floor(mixed, solver):
    tm, ref_u = mixed
    params = {**solver, **MIXED}
    st, ct, pt = forward.run_inputs(tm, *port_inputs(tm))
    fac = tm.factorize(st, {k: v[0] for k, v in ct.items()}, pt, 5e-5, params)
    assert fac.Sinv.dtype == torch.float32 and fac.d.dtype == torch.float32
    _, traj, infos = forward.integrate_pure(tm, *port_inputs(tm), TIMES, params)
    _check_mixed(traj, infos, ref_u)


def test_exact_solve_keeps_factor_dtype(mixed):
    """A tangent's exact solve (and the exact adjoint's) drops the storage
    dtypes but keeps ``btd_factor_dtype``: f32 factors solve under the f64
    vectors, as the JAX package's ``solve_u1`` rules do."""
    tm, _ = mixed
    solid = tm.solid
    st, ct, pt = forward.run_inputs(tm, *port_inputs(tm))
    inputs = tm._solid_inputs(st, pt)
    params = {"linear_solver": "btd", "btd_store_dtype": "float8_e4m3fn",
              "btd_offdiag_dtype": "float8_e5m2", **MIXED}
    seen = []
    make = solid.make_iter_factors

    def spy(*args):
        fac = make(*args)
        seen.append(tuple(t.dtype for t in fac))
        return fac

    solid.make_iter_factors = spy
    try:
        r = torch.as_tensor(np.random.default_rng(0).standard_normal(solid.ndof))
        for transpose in (False, True):
            x = solid._exact_solve(st["u"], inputs, 5e-5, params, r, transpose)
            assert x.dtype == torch.float64 and bool(torch.isfinite(x).all())
    finally:
        del solid.make_iter_factors
    assert seen == [(torch.float32,) * 4] * 2


def test_dd_f32_factors_reach_f64_floor():
    """tests/test_ddstep.py:769-800: the sharded loop over 4 stacked shards
    with f32 SPIKE factors reproduces its f64 run at the f64 level and
    meets the reference tolerances each step."""
    tm = port_dd_model(40, 20)
    times = 5e-5 * np.arange(17)
    _, t64, _ = ddstep.DDIntegrator(tm, 4, {"jacobian_refresh_steps": 8}).integrate_pure(
        *port_inputs(tm), times)
    dd = ddstep.DDIntegrator(tm, 4, MIXED)
    seen, factorize = [], dd._factorize_step

    def spy(*args, **kwargs):
        fac = factorize(*args, **kwargs)
        seen.append((fac.Sinv.dtype, fac.P.dtype, fac.d.dtype))
        return fac

    dd._factorize_step = spy
    _, tmx, infos = dd.integrate_pure(*port_inputs(tm), times)
    assert seen == [(torch.float32,) * 3] * 2
    _check_mixed(tmx, infos, t64["u"].numpy())
