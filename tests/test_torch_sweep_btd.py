"""
A batch of variants on the block-Thomas direct solver
(``linear_solver='btd'``; ``parallel.sweep``, ``forward.integrate_batch_pure``)
against the JAX package's ``sweep_integrate`` / ``sweep_grad`` (``vmap`` of
``integrate_pure``: ``tests/data/golden_sweep_solvers.npz``, written by
``tests/make_golden_sweep_solvers.py`` from ``tests/sweep_solver_cases.py``)
and against the port's own unbatched runs, on the CPU in f64 (the plain
versions of K6 and K6T over the batch's chains).

The model is KelvinVoigtWEpithelium + BernoulliAreaRatioSep on the
RCM-renumbered ``vocal_fold_mesh(24, 6)`` (350 dofs: three super-rows of
128, so that each variant's chain has an interior row), with
``tests/test_torch_btd.py``'s ``PROD_SMALL`` settings and emod varied across
the batch: f64 factors against the JAX package at rtol 1e-8 and each row
against its variant's unbatched run at rtol 1e-10; bf16 factors, on
``tests/test_torch_btd.py``'s own model and 20-step run, against the JAX
package within 10x their measured difference; the step that the card captures, run
uncaptured on the CPU, against the batched eager loop bit for bit; each
option of the unbatched step in a batch; ``sweep_grad`` against the JAX
package's; one tangent row against its variant's; and a batch of the small
extruded 3D stack (``tests/cases_3d.py``'s ``btd3d``).
"""

import os

import numpy as np
import pytest
import torch

import cases_3d
import dynamical_cases
import sweep_solver_cases as sc
from vf_fem_tpu_torch import forward, step_graph
from vf_fem_tpu_torch.models.transient import solver_params
from vf_fem_tpu_torch.parallel import sweep

from port_fixtures import port_inputs

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "data", "golden_sweep_solvers.npz"))
B = sc.B
PROD_SMALL, F64 = sc.PROD_SMALL, sc.BTD_F64
TIMES = sc.times_of("btd_f64", None)
JAX_RTOL = 1e-8
ROW_RTOL = 1e-10
# max|x_port - x_jax| / max|x_jax| of the bf16 batch's final state over its
# variants against the JAX package's sweep, measured on a CPU (x86-64);
# each field is held at 10x its difference.  tests/test_torch_btd.py's
# PROD_SMALL_DIFF (the unbatched run of emod 5e4 against the JAX package's
# unbatched run) does not bound it: the JAX package's vmapped run sums its
# bf16 products in another order than its unbatched run, and the fixed-3
# chord carries that (a: 2.7e-5 at emod 6e4, q: 1.1e-8); the port's rows
# equal its unbatched runs at ROW_RTOL (test_rows_equal_unbatched)
BATCH_BF16_DIFF = {"u": 7.417e-08, "v": 1.982e-06, "a": 2.716e-05, "q": 1.086e-08,
                   "p": 3.729e-09}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden(case, part):
    """``{key: array}`` of a case's ``part`` ('fin', 'prop', 'grad')."""
    pre = f"{case}|{part}|"
    return {k[len(pre):]: GOLDEN[k] for k in GOLDEN.files if k.startswith(pre)}


def assert_rows_alone(model, fin, pb, times, params, rows, rtol=ROW_RTOL):
    """Rows ``rows`` of a batch's final state ``fin`` against their
    variants' unbatched runs (every field at ``rtol``, atol 1e-14 of the
    field's largest entry)."""
    s0, cs, _ = port_inputs(model)
    for b in rows:
        one, _, _ = forward.integrate_pure(model, s0, cs, {k: v[b] for k, v in pb.items()},
                                           times, {"assembly": sweep.ASSEMBLY, **params})
        for k in one:
            np.testing.assert_allclose(fin[k][b].numpy(), one[k].numpy(), rtol=rtol,
                                       atol=1e-14 * one[k].abs().max().item(),
                                       err_msg=f"row {b} {k}")


@pytest.fixture(scope="module")
def models():
    """The case's model (three super-rows) and tests/test_torch_btd.py's."""
    tm = sc.port_model("btd")
    plan, _ = tm.solid.bsb_plan()
    assert -(-plan.nblk // plan.h) >= 3
    return {"btd": tm, "btd_small": sc.port_model("btd_small")}


def run_case(model, case):
    """The port's ``sweep_integrate`` of a 'run' case, its batch held to the
    golden's: ``(fin, infos, batch)``."""
    params = sc.CASES[case][3]
    s0, cs, prop = port_inputs(model)
    pb = sc.batch(prop)
    for k, v in golden(case, "prop").items():
        np.testing.assert_array_equal(pb[k], v, err_msg=k)
    fin, info = sweep.sweep_integrate(model, s0, cs, pb, sc.times_of(case, None), params)
    return fin, info, pb


@pytest.fixture(scope="module")
def port_runs(models):
    return {"f64": run_case(models["btd"], "btd_f64"),
            "bf16": run_case(models["btd_small"], "btd_bf16")}


def assert_grads_close(grads, case, prop_batch, rtol=JAX_RTOL):
    """A sweep's gradients (``{key: (B, ...)}``) against the golden's:
    each key within ``rtol`` of its largest entry, except a key whose
    sensitivity max|g| max|p| is below 1e-12 of the largest value (a
    property whose effect on the value is at the rounding floor, such as a
    smoothing width far below the flow's scale: its gradient is rounding
    noise), which must be as small in the port's."""
    floor = 1e-12 * np.abs(GOLDEN[f"{case}|values"]).max()
    for k, ref in golden(case, "grad").items():
        p = max(np.abs(np.asarray(prop_batch[k])).max(), 1e-300)
        if np.abs(ref).max() * p <= floor:
            assert np.abs(grads[k].numpy()).max() * p <= floor, k
            continue
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=0,
                                   atol=rtol * np.abs(ref).max(), err_msg=k)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_f64_sweep_matches_jax(port_runs):
    """f64 factors: every variant's final state within rtol 1e-8 (atol
    1e-12 of the field's largest entry) of the JAX package's sweep, the
    Newton iterations equal."""
    fin, info, _ = port_runs["f64"]
    assert info.num_iter.shape == (B, len(TIMES) - 1)
    np.testing.assert_array_equal(info.num_iter.numpy(), GOLDEN["btd_f64|num_iter"])
    for k, ref in golden("btd_f64", "fin").items():
        np.testing.assert_allclose(fin[k].numpy(), ref, rtol=JAX_RTOL,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)
    u = fin["u"].numpy()
    assert len({u[b].tobytes() for b in range(B)}) == B


def test_bf16_sweep_matches_jax(port_runs):
    """bf16 factors (tests/test_torch_btd.py's model and 20-step run):
    each variant's fields, max|diff| / max|x|, against the JAX package's
    sweep within 10x their measured difference (``BATCH_BF16_DIFF``),
    three Newton iterations every step."""
    fin, info, _ = port_runs["bf16"]
    assert (info.num_iter.numpy() == 3).all()
    np.testing.assert_array_equal(info.num_iter.numpy(), GOLDEN["btd_bf16|num_iter"])
    for k, ref in golden("btd_bf16", "fin").items():
        for b in range(B):
            assert _rel(fin[k][b].numpy(), ref[b]) <= 10 * BATCH_BF16_DIFF[k], (k, b)


@pytest.mark.parametrize("name", ["f64", "bf16"])
def test_rows_equal_unbatched(models, port_runs, name):
    """Each row against its variant's unbatched run (rtol 1e-10)."""
    case = f"btd_{name}"
    fin, _, pb = port_runs[name]
    assert_rows_alone(models[sc.CASES[case][0]], fin, pb, sc.times_of(case, None),
                      sc.CASES[case][3], range(B))


def test_graph_step_matches_eager(models):
    """The step that the card captures (``step_graph.integrate`` with a
    batch, run uncaptured on the CPU: the batch's factors copied into the
    step's buffers each window) against the batched eager loop with its
    carried factors and refresh windows, bit for bit."""
    tm = models["btd"]
    s0, cs, prop = port_inputs(tm)
    params = solver_params({**PROD_SMALL, "assembly": "plain", "jacobian_refresh_steps": 4})
    batch = (B, False)
    ref = forward._integrate_eager(tm, s0, cs, sc.batch(prop), TIMES, params, batch)
    got = step_graph.integrate(tm, s0, cs, sc.batch(prop), TIMES, params, batch)
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
        assert torch.equal(got[1][k], ref[1][k]), k
    for a, b in zip(got[2], ref[2]):
        assert torch.equal(a, b)


# the options of the unbatched step, each in a batch
OPTIONS = {
    "fp8-offdiag": {**PROD_SMALL, "btd_offdiag_dtype": "float8_e4m3fn"},
    "fp8-store": {**PROD_SMALL, "btd_store_dtype": "float8_e5m2"},
    "f32-factors": {**F64, "btd_factor_dtype": "float32"},
    "extrapolated": {**F64, "initial_guess": "extrapolated"},
    "every-iteration": {"linear_solver": "btd", "jacobian_update": "every_iteration",
                        "stagnation_ratio": 0.5},
    "adaptive": {"linear_solver": "btd", "jacobian_refresh_steps": 4, "stagnation_ratio": 0.5},
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_in_a_batch(models, option):
    """Each option of the unbatched 'btd' step in a batch of 2 (6 steps):
    every row against its variant's unbatched run (rtol 1e-10), the Newton
    iterations of each row its own."""
    tm = models["btd"]
    params = OPTIONS[option]
    s0, cs, prop = port_inputs(tm)
    pb = {k: v[:2] for k, v in sc.batch(prop).items()}
    times = TIMES[:7]
    fin, info = sweep.sweep_integrate(tm, s0, cs, pb, times, params)
    assert_rows_alone(tm, fin, pb, times, params, range(2))
    _, _, one_info = forward.integrate_pure(tm, s0, cs, {k: v[1] for k, v in pb.items()},
                                            times, {"assembly": sweep.ASSEMBLY, **params})
    assert torch.equal(info.num_iter[1], one_info.num_iter)


@pytest.mark.parametrize("refine", ["stale", "exact"])
def test_sweep_grad_matches_jax(models, refine):
    """``sweep_grad`` with f64 factors (refresh 4 over 6 steps; the refined
    stale adjoint and the exact one) against the JAX package's: the values
    and every property's gradient within rtol 1e-8 of each one's largest
    entry."""
    case = f"btd_grad_{refine}"
    tm = models["btd"]
    s0, cs, prop = port_inputs(tm)
    vals, grads = sweep.sweep_grad(tm, sc.fsi_loss(torch), s0, cs, sc.batch(prop),
                                   sc.times_of(case, None), sc.CASES[case][3])
    ref = GOLDEN[f"{case}|values"]
    np.testing.assert_allclose(vals.numpy(), ref, rtol=0, atol=JAX_RTOL * np.abs(ref).max())
    assert np.abs(GOLDEN[f"{case}|grad|emod"]).max() > 0
    assert_grads_close(grads, case, sc.batch(prop))


def test_tangent_row_equals_unbatched(models):
    """``integrate_linear_batch_pure`` with bf16 factors (the tangent's
    solves drop the storage dtype): row 1 against ``integrate_linear_pure``
    of its variant at rtol 1e-10."""
    tm = models["btd"]
    s0, cs, prop = port_inputs(tm)
    pb = {k: v[:2] for k, v in sc.batch(prop).items()}
    times = TIMES[:7]
    rng = np.random.default_rng(5)
    dpb = {k: np.zeros(np.shape(v)) for k, v in pb.items()}
    dpb["emod"] = 100.0 * rng.standard_normal(np.shape(pb["emod"]))
    ds0 = {k: np.zeros(np.shape(v)) for k, v in s0.items()}
    dcs = {k: np.zeros(np.shape(v)) for k, v in cs.items()}
    params = {"assembly": "plain", **PROD_SMALL, "jacobian_refresh_steps": 4}
    fin, dfin = forward.integrate_linear_batch_pure(tm, s0, cs, pb, times, ds0, dcs, dpb,
                                                    np.zeros(len(times)), params)
    one, done = forward.integrate_linear_pure(tm, s0, cs, {k: v[1] for k, v in pb.items()},
                                              times, ds0, dcs, {k: v[1] for k, v in dpb.items()},
                                              np.zeros(len(times)), params)
    for k in ("u", "q", "p"):
        np.testing.assert_allclose(dfin[k][1].numpy(), done[k].numpy(), rtol=ROW_RTOL,
                                   atol=1e-14 * done[k].abs().max().item(), err_msg=k)
        np.testing.assert_allclose(fin[k][1].numpy(), one[k].numpy(), rtol=ROW_RTOL,
                                   atol=1e-14 * one[k].abs().max().item(), err_msg=k)


def test_extruded_3d_batch():
    """A batch of 2 variants of the small extruded stack (``btd3d``:
    M5_CB_GA3 at h 0.1 through 3 z-planes, 477 dofs, one fluid channel a
    plane) on its 'btd' settings, 6 steps: each row against its unbatched
    run (rtol 1e-10)."""
    model, _, times = cases_3d.build(dynamical_cases.port_pkg(), "btd3d")
    times = times[:7]
    params = {"assembly": "banded", "linear_solver": "btd", "jacobian_refresh_steps": 4,
              "fixed_iterations": 3}
    s0, cs, prop = port_inputs(model)
    pb = {k: np.broadcast_to(np.asarray(v), (2,) + np.shape(v)).copy() for k, v in prop.items()}
    pb["emod"] = pb["emod"] * np.array([0.9, 1.1])[:, None]
    fin, _ = sweep.sweep_integrate(model, s0, cs, pb, times, params)
    assert_rows_alone(model, fin, pb, times, params, range(2))
