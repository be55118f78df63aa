"""
``initial_guess='extrapolated'`` (the correction-memory predictor of
``vf_fem_tpu/forward.py:75-128``: each step's Newton starts from the
Newmark predictor plus the previous step's ``u1 - predictor``) in the
port, ``tests/test_forward.py:272-325`` at a small size: on the plain and
the stale-factor paths it reproduces the 'predictor' trajectory to the
solver tolerance (rtol 1e-8, atol 1e-11), ``integrate_grad``'s gradient
equals the 'predictor' one (rtol 1e-8: the guess gets no cotangent), the
port's run equals the JAX package's own 'extrapolated' run, and the step
graph's step (uncaptured on the CPU), with the correction in its buffers,
is the eager loop bit for bit, of one variant and of a batch.
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import adjoint, forward, step_graph
from vf_fem_tpu_torch.models.transient import solver_params

from fixture_models import make_vf_fsi_model
from port_fixtures import (
    HEADLINE_SMALL, assert_runs_match, port_inputs, port_smooth_model, run_both,
)

TIMES = 5e-5 * np.arange(25)
STALE = {"jacobian_refresh_steps": 8, "jacobian_refresh_mode": "ns",
         "jacobian_full_refresh_windows": 4, "jacobian_update": "once_per_step"}
EXTRAP = {"initial_guess": "extrapolated"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX package's and the port's smooth 8 x 4 fold (the adjoint
    tests' model)."""
    from vf_fem_tpu.residuals import fluid as jflr

    jm = make_vf_fsi_model(FluidResidual=jflr.BernoulliSmoothMinSep, nx=8, ny=4)
    return jm, port_smooth_model(jm)


@pytest.mark.parametrize("base", [{}, STALE], ids=["plain", "stale"])
def test_extrapolated_matches_predictor(models, base):
    _, tm = models
    runs, counts = [], []
    for extra in ({}, EXTRAP):
        tm.solid.predictor_counts.update(carried=0, formed=0)
        runs.append(forward.integrate_pure(tm, *port_inputs(tm), TIMES, {**base, **extra}))
        counts.append(dict(tm.solid.predictor_counts))
    (_, traj_a, _), (_, traj_b, info_b) = runs
    np.testing.assert_allclose(traj_b["u"].numpy(), traj_a["u"].numpy(), rtol=1e-8, atol=1e-11)
    assert np.all(info_b.abs_err.numpy() < 1e-6)
    # the steps read the predictors K5 carried, as the 'predictor' run's do
    assert counts[1] == counts[0]


def test_extrapolated_implicit_matches_predictor(models):
    """The implicit (Picard) model: the extrapolated guess is each step's
    first Picard iterate (its 'u'), as in the JAX package's loop; the run
    reproduces the 'predictor' run at rtol 1e-8 with as many Picard
    iterations."""
    jm, _ = models
    tm = port_smooth_model(jm, coupling="implicit")
    times = TIMES[:13]
    runs, counts = [], []
    for extra in ({}, EXTRAP):
        tm.picard_counts.update(steps=0, iterations=0, newton_iterations=0)
        runs.append(forward.integrate_pure(tm, *port_inputs(tm), times, extra))
        counts.append(tm.picard_counts["iterations"])
    np.testing.assert_allclose(runs[1][1]["u"].numpy(), runs[0][1]["u"].numpy(), rtol=1e-8,
                               atol=1e-11)
    assert counts[1] == counts[0]


def test_extrapolated_matches_jax(models):
    """The port's 'extrapolated' run on the stale path against the JAX
    package's own, field by field at rtol 1e-10 with equal iterations."""
    jm, tm = models
    jax_run, port_run = run_both(jm, tm, TIMES, {**STALE, **EXTRAP})
    assert_runs_match(jax_run, port_run, 1e-10)


def _loss(traj, controls, prop, times):
    """tests/test_forward.py:309-313: sum(u[-1]^2)."""
    return torch.sum(traj["u"][-1] ** 2)


def test_extrapolated_gradient_equals_predictors(models):
    """``integrate_grad`` of sum(u[-1]^2): the 'extrapolated' gradient in
    emod equals the 'predictor' one at rtol 1e-8 (atol 1e-12 of its
    largest entry), and its value is its own no-grad forward's."""
    _, tm = models
    s0, _, prop = port_inputs(tm)
    va, ga = adjoint.integrate_grad(tm, _loss, s0, [tm.control], prop, TIMES, None)
    vb, gb = adjoint.integrate_grad(tm, _loss, s0, [tm.control], prop, TIMES, EXTRAP)
    ref = np.abs(ga["prop"]["emod"]).max()
    np.testing.assert_allclose(gb["prop"]["emod"], ga["prop"]["emod"], rtol=1e-8,
                               atol=1e-12 * max(ref, 1.0))
    assert vb == pytest.approx(va, rel=1e-8)
    _, traj, _ = forward.integrate_pure(tm, *port_inputs(tm), TIMES, EXTRAP)
    assert float(_loss(traj, None, None, None)) == vb


@pytest.mark.parametrize("batch", [None, 3], ids=["one", "batch"])
def test_step_graph_step_equals_eager(models, batch):
    """A fixed-iteration run with refresh windows, the step the card
    captures (its correction buffer updated inside the step) run
    uncaptured on the CPU, against the eager loop bit for bit; for a batch
    of 3 stiffness variants, the batched step's."""
    _, tm = models
    params = solver_params({**HEADLINE_SMALL, **EXTRAP})
    s0, cs, prop = port_inputs(tm)
    times = TIMES[:14]
    key = None
    if batch is not None:
        prop = {k: np.stack([np.asarray(v)] * batch) for k, v in prop.items()}
        prop["emod"] = prop["emod"] * np.linspace(0.9, 1.1, batch)[:, None]
        key = (batch, False)
    fin, traj, infos = forward._integrate_eager(tm, s0, cs, prop, times, params, key)
    gfin, gtraj, ginfos = step_graph.integrate(tm, s0, cs, prop, times, params, key)
    for k in traj:
        assert torch.equal(gtraj[k], traj[k]) and torch.equal(gfin[k], fin[k]), k
    assert all(torch.equal(a, b) for a, b in zip(ginfos, infos))
    if batch is not None:  # row 1 against that variant alone
        one = {k: v[1] for k, v in prop.items()}
        _, traj1, _ = forward._integrate_eager(tm, s0, cs, one, times, params)
        np.testing.assert_allclose(traj["u"][:, 1].numpy(), traj1["u"].numpy(), rtol=1e-10,
                                   atol=1e-12 * traj1["u"].abs().max().item())
