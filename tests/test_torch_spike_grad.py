"""
Gradients and tangents through ``linear_solver='spike'`` against the JAX
package on the CPU in f64, on the fold of ``tests/test_spike.py:77-143``
(the RCM-renumbered ``vocal_fold_mesh(10, 5)``, KelvinVoigt +
BernoulliSmoothMinSep, 4 partitions, factors refreshed every 3 steps, 6
steps of 5e-5 s from rest):

- value+grad (``adjoint.integrate_grad``) with the refined stale adjoint
  (the transposed SPIKE solve on the window's factors, its transposed parts
  built for the differentiable run) and with ``adjoint_refine='exact'``
  (a transposed SPIKE solve with factors built at u1), against the JAX
  package's gradient at rtol 1e-6 (``tests/test_spike.py:137-143``'s gate),
  and the value against the no-grad forward bit for bit;
- tangents (``forward.integrate_linear_pure``) against ``jax.jvp`` of the
  JAX package's forward-mode integrator at rtol 1e-8, and their duality
  with ``adjoint.integrate_grad`` at 1e-8;

the JAX package's gradient and tangent read from
``tests/data/golden_grad.npz`` (``python tests/make_golden_grad.py --only
spike``; they take 35 s to trace);
- the forward-only factors hold no transposed parts, and their other
  fields are the differentiable run's bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import adjoint, forward, ops
from vf_fem_tpu_torch.convert import to_tensors
from vf_fem_tpu_torch.solvers import spike

from port_fixtures import port_dd_model, port_inputs, seeded_tangents

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_grad.npz")
# tests/make_golden_grad.py's SPIKE_TIMES, SPIKE and SPIKE_TANGENT_SEED
TIMES = 5e-5 * np.arange(7)
SPIKE = {"linear_solver": "spike", "spike_partitions": 4, "jacobian_refresh_steps": 3}
TANGENT_SEED = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small tensor ops a step: one thread (see
    ``tests/test_torch_ddstep.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return port_dd_model(10, 5)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _loss(traj, controls, prop, times):
    return torch.sum(traj["u"][-1] ** 2) * 1e4


@pytest.mark.parametrize("refine", ["stale", "exact"])
def test_spike_grad_matches_jax(model, golden, refine):
    """Every property's gradient within 1e-6 of its largest entry of the JAX
    package's (spike, refined stale adjoint); the value within 1e-12 of the
    JAX package's and the no-grad forward's bit for bit; on the CPU no
    kernel launches."""
    tm = model
    s0, _, prop = port_inputs(tm)
    before = dict(ops.LAUNCHES)
    counts = dict(tm.solid.adjoint_counts)
    value, g = adjoint.integrate_grad(tm, _loss, s0, [tm.control], prop, TIMES,
                                      {**SPIKE, "adjoint_refine": refine})
    assert ops.LAUNCHES == before
    assert tm.solid.adjoint_counts["solves"] - counts["solves"] == len(TIMES) - 1
    fin, _, _ = forward.integrate_pure(tm, *port_inputs(tm), TIMES, SPIKE)
    assert value == float(_loss({"u": fin["u"][None]}, None, None, None))
    jv = float(golden["spike_value"])
    jg = {k: golden[f"spike_grad_{k}"] for k in prop}
    np.testing.assert_allclose(value, jv, rtol=1e-12)
    assert_prop_grads_close(g["prop"], jg, 1e-6, jv)


def assert_prop_grads_close(gp, gj, rtol, value):
    """Each property's gradient within ``rtol`` of its largest JAX entry; a
    key whose JAX gradient is below 1e-12 |value| is the rounding of a
    vanishing derivative (``rho_air`` on the solid: Bernoulli's rho q^2
    does not depend on rho), and the port's must be below that too (the
    rule of ``tests/test_torch_adjoint.py``)."""
    for k, ref in gj.items():
        scale, floor = np.abs(ref).max(), 1e-12 * abs(value)
        if scale <= floor:
            assert np.abs(gp[k]).max() <= floor, k
            continue
        err = np.abs(gp[k] - ref).max()
        assert err <= rtol * scale, f"{k}: {err:.3e} of {scale:.3e}"


def test_spike_tangent_matches_jax(model, golden):
    """``integrate_linear_pure`` through 'spike' (the tangent solve with
    f64 SPIKE factors built at u1) against ``jax.jvp`` of the JAX package's
    forward-mode integrator with the same settings, along the same seeded
    tangents: rtol 1e-8."""
    tm = model
    s0, cs, prop = port_inputs(tm)
    tangents = seeded_tangents(s0, cs, prop, TIMES, TANGENT_SEED)
    _, td = forward.integrate_linear_pure(tm, s0, cs, prop, TIMES, *tangents, SPIKE)
    assert set(td) == set(tm.state0)
    for k, d in td.items():
        r = golden[f"spike_tangent_{k}"]
        np.testing.assert_allclose(d.numpy(), r, rtol=1e-8, atol=1e-8 * np.abs(r).max(),
                                   err_msg=k)


def test_spike_jvp_vjp_duality(model):
    """<hy, J dx> = <J^T hy, dx> with J = d u_final / d emod through
    'spike': the tangent run against ``adjoint.integrate_grad`` with the
    exact adjoint (transposed SPIKE solves with factors built at u1, as the
    tangent's solves are), rtol 1e-8.  The refined stale adjoint stops at
    ``adjoint_refine_tol`` (1e-8 of the residual; 3e-8 apart here), and is
    held to the exact one by :func:`test_spike_grad_matches_jax`."""
    tm = model
    s0, cs, prop = port_inputs(tm)
    rng = np.random.default_rng(2)
    dx = rng.standard_normal(prop["emod"].shape)
    hy = torch.as_tensor(rng.standard_normal(tm.solid.ndof))
    dprop = {k: np.zeros_like(v) for k, v in prop.items()}
    dprop["emod"] = dx
    _, td = forward.integrate_linear_pure(
        tm, s0, cs, prop, TIMES, {k: np.zeros_like(v) for k, v in s0.items()},
        {k: np.zeros_like(v) for k, v in cs.items()}, dprop, np.zeros_like(TIMES), SPIKE)
    _, g = adjoint.integrate_grad(
        tm, lambda traj, c, p, t: torch.dot(hy, traj["u"][-1]), s0, [tm.control], prop,
        TIMES, {**SPIKE, "adjoint_refine": "exact"})
    np.testing.assert_allclose(float(torch.dot(hy, td["u"])),
                               float(np.dot(g["prop"]["emod"], dx)), rtol=1e-8)


def test_forward_factors_leave_out_the_transpose(model):
    """A forward run's SPIKE factors hold None for the transposed parts, and
    the fields they hold equal those of the factors a differentiable run
    builds (``with_transpose``) bit for bit."""
    tm = model
    s0, _, prop = port_inputs(tm)
    state = to_tensors({**{k: np.zeros_like(v) for k, v in tm.state0.items()}, **s0},
                       "cpu", torch.float64)
    prop_t = to_tensors(prop, "cpu", torch.float64)
    fwd = tm.factorize(state, None, prop_t, 5e-5, SPIKE)
    diff = tm.factorize(state, None, prop_t, 5e-5, {**SPIKE, "with_transpose": True})
    for f in ("Vh", "Wh", "Sinv_rt", "L_rt", "U_rt"):
        assert getattr(fwd, f) is None and getattr(diff, f) is not None, f
    for f in spike.SPIKEFactors._fields[:9]:
        assert torch.equal(getattr(fwd, f), getattr(diff, f)), f
