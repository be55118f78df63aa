"""
Gradients through the two-way FSAI coupling on the CPU in f64: the RMS
radiated pressure (``functional.acoustic.RmsRadiatedPressure``) over 40
steps of the 8 x 4 model of ``tests/test_fsai.py`` (12 tubes), its
value and gradient by ``adjoint.integrate_grad`` against ``jax.grad`` of
the JAX package's run (the value within 1e-10, the gradients with respect
to psub, the tract's ``area`` and ``emod`` within rtol 1e-7 of each key's
largest entry), the value the no-grad forward's bit for bit, and the
gradient along psub and along a seeded direction of tract areas against
central differences (rtol 1e-4).  The block-Thomas path and the statefile
entry point are ``tests/test_torch_fsai_adjoint.py``'s.
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import adjoint, forward
from vf_fem_tpu_torch.functional.acoustic import RmsRadiatedPressure

from port_fixtures import port_fsai_model, port_inputs
from test_fsai import make_fsai_model

N_STEPS = 40
FD_RTOL = 1e-4
JAX_RTOL = 1e-7


@pytest.fixture(scope="module")
def models():
    jm = make_fsai_model(nx=8, ny=4)
    return jm, port_fsai_model(jm, nx=8, ny=4)


@pytest.fixture(scope="module")
def jax_grads(models):
    """value and gradients (prop dict, psub) of the JAX package's loss."""
    import jax
    import jax.numpy as jnp

    from vf_fem_tpu import forward as jforward
    from vf_fem_tpu.functional.acoustic import RmsRadiatedPressure as JRms

    from port_fixtures import jax_inputs

    jm, _ = models
    state0, cs, pd = jax_inputs(jm)
    times = jnp.asarray(jm.dt * np.arange(N_STEPS + 1))
    func = JRms(jm)

    def loss(p, psub):
        cs2 = {**cs, "psub": jnp.full_like(jnp.asarray(cs["psub"]), psub)}
        _, traj, _ = jforward.integrate_pure(jm, state0, cs2, p, times, use_remat=True)
        full = {k: jnp.concatenate([jnp.asarray(state0[k])[None], traj[k]], axis=0)
                for k in traj}
        return func.eval_traj(full, times, cs2, p)

    val, (g_prop, g_psub) = jax.value_and_grad(loss, argnums=(0, 1))(
        pd, jnp.asarray(float(jm.control["psub"][0])))
    return float(val), {k: np.asarray(v) for k, v in g_prop.items()}, float(g_psub)


@pytest.fixture(scope="module")
def port_grad(models):
    _, tm = models
    state0, _, prop = port_inputs(tm)
    times = tm.dt * np.arange(N_STEPS + 1)
    return adjoint.integrate_grad(tm, RmsRadiatedPressure(tm), state0, [tm.control], prop,
                                  times)


def _value(tm, psub=None, prop=None):
    """The no-grad forward's loss."""
    state0, cs, p = port_inputs(tm)
    if psub is not None:
        cs = {**cs, "psub": np.full_like(cs["psub"], psub)}
    p = prop if prop is not None else p
    times = tm.dt * np.arange(N_STEPS + 1)
    _, traj, _ = forward.integrate_pure(tm, state0, cs, p, times)
    full = {k: torch.cat([torch.as_tensor(state0[k])[None], traj[k]]) for k in traj}
    t = torch.as_tensor(times)
    return float(RmsRadiatedPressure(tm).eval_traj(full, t, None, {k: torch.as_tensor(v)
                                                                    for k, v in p.items()}))


def test_value_is_the_forwards(models, port_grad):
    _, tm = models
    assert port_grad[0] == _value(tm) and port_grad[0] > 0


def test_grad_matches_jax(port_grad, jax_grads):
    value, grads = port_grad
    jval, jprop, jpsub = jax_grads
    np.testing.assert_allclose(value, jval, rtol=1e-10)
    np.testing.assert_allclose(grads["controls"]["psub"].sum(), jpsub, rtol=JAX_RTOL)
    for k in ("area", "emod", "proploss"):
        ref = jprop[k]
        assert np.abs(ref).max() > 0 and np.isfinite(grads["prop"][k]).all()
        np.testing.assert_allclose(grads["prop"][k], ref, rtol=JAX_RTOL,
                                   atol=JAX_RTOL * np.abs(ref).max(), err_msg=k)


def test_grad_matches_central_differences(models, port_grad):
    _, tm = models
    _, grads = port_grad
    psub = float(tm.control["psub"][0])
    fd = (_value(tm, psub=psub + 1.0) - _value(tm, psub=psub - 1.0)) / 2.0
    np.testing.assert_allclose(grads["controls"]["psub"].sum(), fd, rtol=FD_RTOL)
    d = np.random.default_rng(5).standard_normal(tm.prop["area"].shape)
    h = 1e-4
    vals = []
    for s in (h, -h):
        prop = {k: v.copy() for k, v in tm.prop.items()}
        prop["area"] = prop["area"] + s * d
        vals.append(_value(tm, prop=prop))
    fd = (vals[0] - vals[1]) / (2 * h)
    np.testing.assert_allclose(np.dot(grads["prop"]["area"], d), fd, rtol=FD_RTOL)

