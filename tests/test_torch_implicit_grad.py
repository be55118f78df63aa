"""
Gradients and tangents through the port's implicit (Picard) coupling
(``ImplicitFSIModel.step_diff``: the coupled IFT rule on the dense
Jacobian of ``res_pure``, built by a chunked ``jacfwd`` through K1/K2's
vmap rules) against the JAX package's coupled ``custom_vjp`` /
``custom_jvp`` on the CPU in f64, on the model of
``tests/test_adjoint.py:139-164`` (KelvinVoigt + BernoulliSmoothMinSep,
6 x 3, 3 steps at dt = 2e-5, its functional):

- ``adjoint.integrate_grad`` with the solid's Jacobian re-assembled in
  each solve, and with factors carried through windows of 2 steps and
  Aitken relaxation, against the JAX package's gradient: each key of each
  group within rtol 1e-8 of its largest entry; the value the no-grad
  forward's bit for bit;
- the derivative in psub against a central difference (h = 1 Ba, rtol
  1e-4, ``tests/test_adjoint.py:139-164``);
- ``forward.integrate_linear_pure`` along psub against ``jax.jvp`` of the
  JAX package's forward-mode integrator, rtol 1e-8.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vf_fem_tpu import adjoint as jadjoint
from vf_fem_tpu import forward as jforward
from vf_fem_tpu.residuals import fluid as jflr
from vf_fem_tpu_torch import adjoint, forward

from fixture_models import make_vf_fsi_model
from port_fixtures import jax_inputs, port_inputs, port_smooth_model
from test_torch_adjoint import _functional, _jax_functional, assert_grads_close

TIMES = 2e-5 * np.arange(4)


@pytest.fixture(scope="module")
def models():
    jm = make_vf_fsi_model(FluidResidual=jflr.BernoulliSmoothMinSep,
                           coupling="implicit", nx=6, ny=3)
    return jm, port_smooth_model(jm, coupling="implicit", nx=6, ny=3)


@pytest.fixture(scope="module")
def jax_grad(models):
    jm, _ = models
    ini = jm.state0.copy()
    ini[:] = 0.0
    return jadjoint.integrate_grad(jm, _jax_functional, ini, [jm.control], jm.prop, TIMES)


def _value(tm, control, params=None):
    s0, _, prop = port_inputs(tm)
    _, traj, _ = forward.integrate_pure(tm, s0, {k: v[None] for k, v in control.items()},
                                        prop, TIMES, params)
    return float(_functional(traj, None, None, None))


@pytest.mark.parametrize("params", [{}, {"jacobian_refresh_steps": 2, "aitken": True}],
                         ids=["exact", "stale-aitken"])
def test_integrate_grad_matches_jax(params, models, jax_grad):
    _, tm = models
    vj, gj = jax_grad
    s0, _, prop = port_inputs(tm)
    vp, gp = adjoint.integrate_grad(tm, _functional, s0, [tm.control], prop, TIMES, params)
    assert vp == _value(tm, tm.control, params)
    np.testing.assert_allclose(vp, vj, rtol=1e-12)
    assert_grads_close(gp, gj, 1e-8, vj)


def test_grad_matches_fd(models):
    """tests/test_adjoint.py:139-164 on the port."""
    _, tm = models
    s0, _, prop = port_inputs(tm)
    _, grads = adjoint.integrate_grad(tm, _functional, s0, [tm.control], prop, TIMES)
    h = 1.0
    vals = [_value(tm, {**tm.control, "psub": tm.control["psub"] + d}) for d in (h, -h)]
    fd = (vals[0] - vals[1]) / (2 * h)
    assert fd != 0
    np.testing.assert_allclose(grads["controls"]["psub"].sum(), fd, rtol=1e-4)


def test_integrate_linear_matches_jax(models):
    """The tangent along psub of every field of the final state."""
    jm, tm = models
    s0, cs, prop = jax_inputs(jm)
    dcs = {k: np.zeros_like(v) for k, v in cs.items()}
    dcs["psub"][:] = 1.0
    ds0 = {k: np.zeros_like(v) for k, v in s0.items()}
    dprop = {k: np.zeros_like(np.asarray(v)) for k, v in prop.items()}
    dtimes = np.zeros(len(TIMES))

    def run(*a):
        return jforward.integrate_pure(jm, *a, {}, mode="fwd")[0]

    _, jd = jax.jvp(run, (s0, cs, prop, jnp.asarray(TIMES)),
                    (ds0, dcs, dprop, jnp.asarray(dtimes)))
    _, td = forward.integrate_linear_pure(tm, *port_inputs(tm), TIMES, ds0, dcs, dprop,
                                          dtimes)
    for k, r in jd.items():
        r = np.asarray(r)
        np.testing.assert_allclose(td[k].numpy(), r, rtol=1e-8,
                                   atol=1e-8 * np.abs(r).max(), err_msg=k)
