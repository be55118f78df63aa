"""
Implicit (Picard) FSI coupling in the port with the solid's Jacobian
factors carried through refresh windows (``ImplicitFSIModel.
step_pure_stale``), on the CPU in f64:

- the model of ``tests/fixture_models.make_vf_fsi_model`` (KelvinVoigt +
  BernoulliSmoothMinSep, 8 x 4) through both packages over 20 steps at
  dt = 5e-5, windows of 8 steps, plain and Aitken Picard: every field of
  the trajectory within rtol 1e-9 (atol 1e-12 of the field's largest
  entry), the Picard iterations equal step by step;
- the JAX package's own checks (``tests/test_forward.py:326-382``, its
  12 x 6 model) on the port: stale against exact rtol 1e-7 over 24 steps,
  Aitken against plain rtol 1e-8 over 14 steps with no more iterations +
  0.5;
- the block-Thomas case of ``tests/test_bsb.py:355-398`` (RCM mesh,
  banded + 'btd', refresh 6, against the exact run, 1e-7).
"""

import numpy as np
import pytest

from vf_fem_tpu.residuals import fluid as jflr
from vf_fem_tpu_torch import forward

from fixture_models import make_vf_fsi_model
from port_fixtures import (assert_runs_match, port_inputs, port_smooth_model,
                           port_vf_model, run_both)


@pytest.mark.parametrize("relaxation", [{}, {"aitken": True}], ids=["plain", "aitken"])
def test_stale_trajectory_matches_jax(relaxation):
    jm = make_vf_fsi_model(FluidResidual=jflr.BernoulliSmoothMinSep,
                           coupling="implicit", nx=8, ny=4)
    tm = port_smooth_model(jm, coupling="implicit")
    assert_runs_match(*run_both(jm, tm, 5e-5 * np.arange(21),
                                {"jacobian_refresh_steps": 8, **relaxation}), 1e-9)


@pytest.fixture(scope="module")
def default_model():
    """The port's make_vf_fsi_model(BernoulliSmoothMinSep, 'implicit')."""
    return port_vf_model("KelvinVoigt", fluid="BernoulliSmoothMinSep", coupling="implicit")


def test_stale_matches_exact(default_model):
    """tests/test_forward.py:326-358."""
    m = default_model
    times = 5e-5 * np.arange(25)
    _, exact, _ = forward.integrate_pure(m, *port_inputs(m), times,
                                         {"jacobian_refresh_steps": 1})
    _, stale, info = forward.integrate_pure(m, *port_inputs(m), times,
                                            {"jacobian_refresh_steps": 8})
    np.testing.assert_allclose(stale["u"].numpy(), exact["u"].numpy(), rtol=1e-7, atol=1e-10)
    assert np.all(info.rel_err.numpy() < 1e-10)
    assert np.all(info.abs_err.numpy() < 1e-4)


def test_aitken_matches_plain(default_model):
    """tests/test_forward.py:361-382."""
    m = default_model
    times = 5e-5 * np.arange(15)
    f0, _, i0 = forward.integrate_pure(m, *port_inputs(m), times, {})
    f1, _, i1 = forward.integrate_pure(m, *port_inputs(m), times, {"aitken": True})
    np.testing.assert_allclose(f1["u"].numpy(), f0["u"].numpy(), rtol=1e-8, atol=1e-11)
    assert np.all(i1.rel_err.numpy() < 1e-10)
    assert i1.num_iter.double().mean() <= i0.num_iter.double().mean() + 0.5


def test_btd_banded_implicit():
    """tests/test_bsb.py:355-398: the Picard loop's solid solves on banded
    assembly and block-Thomas factors carried through windows of 6 steps,
    against the exact-Jacobian implicit run, 1e-7 of max|u|."""
    tm = port_vf_model("KelvinVoigt", 10, 5, reorder="rcm",
                       fluid="BernoulliSmoothMinSep", coupling="implicit")
    times = 5e-5 * np.arange(13)
    _, td, _ = forward.integrate_pure(tm, *port_inputs(tm), times,
                                      {"jacobian_refresh_steps": 1})
    before = dict(tm.solid.predictor_counts)
    _, tb, _ = forward.integrate_pure(
        tm, *port_inputs(tm), times,
        {"assembly": "banded", "linear_solver": "btd", "jacobian_refresh_steps": 6})
    du = np.abs(tb["u"].numpy() - td["u"].numpy()).max()
    assert du < 1e-7 * np.abs(td["u"].numpy()).max()
    # the two windows' factorizations take a predictor each; the Picard
    # solves start from their iterate
    taken = sum(tm.solid.predictor_counts.values()) - sum(before.values())
    assert taken == 2
