"""
Implicit (Picard) FSI coupling in the port (``models.transient.
ImplicitFSIModel``, ``solvers.newton.iterative_solve``) against the JAX
package on the CPU in f64, the solid's Jacobian re-assembled in each
solve:

- the port reproduces ``tests/data/golden_fsi_implicit.npz`` (the JAX
  package's implicit golden, ``tests/test_golden.py:47-73``) at rtol 1e-8;
- the model of ``tests/fixture_models.make_vf_fsi_model`` (KelvinVoigt +
  BernoulliSmoothMinSep, 8 x 4) through both packages over 20 steps at
  dt = 5e-5, plain and Aitken Picard: every field of the trajectory within
  rtol 1e-9 (atol 1e-12 of the field's largest entry), the Picard
  iterations equal step by step;
- routing: ``load_fsi_model``'s default fluid is the JAX package's, an
  unknown coupling raises, an implicit model never runs as a captured
  step graph, and ``initial_guess='given'`` neither reads nor counts the
  carried Newmark predictor.

The carried-factor (stale) runs are ``tests/test_torch_implicit_stale.py``'s,
gradients and tangents ``tests/test_torch_implicit_grad.py``'s.
"""

import os

import numpy as np
import pytest
import torch

from vf_fem_tpu.residuals import fluid as jflr
from vf_fem_tpu_torch import forward, step_graph
from vf_fem_tpu_torch.equations import newmark
from vf_fem_tpu_torch.models.transient import ImplicitFSIModel

from fixture_models import make_vf_fsi_model
from port_fixtures import (assert_runs_match, port_inputs, port_smooth_model,
                           port_vf_model, run_both)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def models():
    jm = make_vf_fsi_model(FluidResidual=jflr.BernoulliSmoothMinSep,
                           coupling="implicit", nx=8, ny=4)
    return jm, port_smooth_model(jm, coupling="implicit")


def test_golden_fsi_implicit():
    """``golden_fsi_implicit.npz`` (KelvinVoigt + BernoulliSmoothMinSep,
    8 x 4, default solver parameters) at its own rtol 1e-8."""
    data = np.load(os.path.join(DATA, "golden_fsi_implicit.npz"))
    tm = port_vf_model("KelvinVoigt", 8, 4, fluid="BernoulliSmoothMinSep",
                       coupling="implicit")
    _, traj, _ = forward.integrate_pure(tm, *port_inputs(tm), data["times"])
    np.testing.assert_allclose(traj["u"].numpy()[::6], data["u"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(traj["q"].numpy().ravel(), data["q"], rtol=1e-8)


@pytest.mark.parametrize("relaxation", [{}, {"aitken": True}], ids=["plain", "aitken"])
def test_trajectory_matches_jax(relaxation, models):
    assert_runs_match(*run_both(*models, 5e-5 * np.arange(21),
                                {"jacobian_refresh_steps": 1, **relaxation}), 1e-9)


def test_default_fluid_is_the_jax_packages():
    """A bare ``load_fsi_model(mesh)`` builds the same residual classes,
    properties and controls (keys, order) in both packages."""
    from vf_fem_tpu.load import load_fsi_model as jload
    from vf_fem_tpu.mesh import vocal_fold_mesh as jmesh
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh

    jm = jload(jmesh(6, 3))
    tm = load_fsi_model(vocal_fold_mesh(6, 3), device="cpu")
    assert type(tm).__name__ == type(jm).__name__ == "ExplicitFSIModel"
    for part in ("solid", "fluid"):
        assert (type(getattr(tm, part).residual).__name__
                == type(getattr(jm, part).residual).__name__)
    assert type(tm.fluid.residual).__name__ == "BernoulliSmoothMinSep"
    assert list(tm.prop) == list(jm.prop.keys())
    assert list(tm.control) == list(jm.control.keys())
    assert list(tm.state0) == list(jm.state0.keys())


def test_coupling_routes():
    """'implicit' builds an ImplicitFSIModel, an unknown coupling raises,
    and ``step_graph.captures`` is False for an implicit model on any
    device, where it is True for the explicit one (its Picard stop reads
    each iteration's residual on the host)."""
    with pytest.raises(ValueError, match="coupling"):
        port_vf_model("KelvinVoigt", 4, 2, coupling="staggered")
    ex = port_vf_model("KelvinVoigt", 4, 2)
    im = port_vf_model("KelvinVoigt", 4, 2, fluid="BernoulliSmoothMinSep",
                       coupling="implicit")
    assert isinstance(im, ImplicitFSIModel) and not isinstance(ex, ImplicitFSIModel)
    graph = {"fixed_iterations": 2, "jacobian_refresh_steps": 4}
    for m in (ex, im):
        m.device = torch.device("cuda")  # captures reads only the attribute
    assert step_graph.captures(ex, graph)
    assert not step_graph.captures(im, graph)


def test_given_guess_skips_the_carried_predictor():
    """``initial_guess='given'``: Newton starts from ``guess['u']`` and the
    predictor K5 carried with the state is neither read nor counted; the
    step still ends through K5, which carries the next predictor."""
    tm = port_vf_model("KelvinVoigt", 6, 3)
    s = tm.solid
    s0, cs, prop = port_inputs(tm)
    state, _ = forward.integrate_step(tm, s0, {k: v[0] for k, v in cs.items()},
                                      prop, 5e-5)
    sl_prop = {k: torch.as_tensor(prop[k]) for k in s.prop}
    st = {k: torch.as_tensor(state[k]) for k in ("u", "v", "a")}
    control = {"p1": torch.zeros(s.nvert, dtype=torch.float64)}
    s.carry_predictor(tuple(st.values()), st["u"] + 1.0, 5e-5)  # a wrong carry
    s.predictor_counts.update(carried=0, formed=0)
    with torch.no_grad():
        given, _ = s.solve_state1_pure(st, control, sl_prop, 5e-5,
                                       {"initial_guess": "given"}, guess=st)
        assert s.predictor_counts == {"carried": 0, "formed": 0}
        carried = s.carried_predictor()
        pred, _ = s.solve_state1_pure(st, control, sl_prop, 5e-5)
    assert s.predictor_counts == {"carried": 0, "formed": 1}
    torch.testing.assert_close(given["u"], pred["u"], rtol=1e-10, atol=1e-14)
    torch.testing.assert_close(carried, newmark.newmark_predict_u(
        given["u"], given["v"], given["a"], 5e-5), rtol=1e-14, atol=0.0)
    with pytest.raises(ValueError, match="guess"):
        s.solve_state1_pure(st, control, sl_prop, 5e-5, {"initial_guess": "given"})
