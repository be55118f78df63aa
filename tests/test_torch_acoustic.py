"""
The WRA vocal tract (``models.acoustic``) and the acoustic functionals
(``functional.acoustic``) of the port against the JAX package on the CPU
in f64:

- the three phases of the update (``make_wra_parts``: ``half``, ``full``,
  ``input_coeffs``) on seeded random partial pressures, flow and tract
  properties (rtol 1e-13);
- the geometry-locked dt, which refuses to be set, and the even tube count;
- a 64-step tract-only run through ``forward.integrate`` and
  ``integrate_pure`` (rtol 1e-12), and both functionals on its trajectory
  (rtol 1e-12);
- the impulse-response impedances, ``input_and_output_impedance(n=256)``
  (rtol 1e-10).
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu.functional import acoustic as jfac
from vf_fem_tpu.models import acoustic as jac
from vf_fem_tpu_torch import forward
from vf_fem_tpu_torch.functional import acoustic as fac
from vf_fem_tpu_torch.models import acoustic as ac

N_TUBE = 20


def _props(model, area=3.0, proploss=0.99, length=17.0):
    """The tract of tests/test_acoustic.py: a uniform tube of 3 cm^2 with a
    slight propagation loss."""
    model.prop["area"][:] = area
    model.prop["proploss"][:] = proploss
    model.prop["length"][:] = length


@pytest.fixture(scope="module")
def tracts():
    jm = jac.WRAnalog(num_tube=N_TUBE)
    _props(jm)
    jm.set_prop(jm.prop)
    tm = ac.WRAnalog(num_tube=N_TUBE, device="cpu")
    _props(tm)
    return jm, tm


@pytest.fixture(scope="module")
def runs(tracts):
    """The 64-step run of both packages from rest at qin = 50 cm^3/s:
    (times, JAX (fin, traj), port (fin, traj), numpy inputs)."""
    jm, tm = tracts
    times = tm.dt * np.arange(64)
    ini = jm.state0.copy()
    ini[:] = 0.0
    control = jm.control.copy()
    control["qin"][:] = 50.0
    jfin, _ = jforward.integrate(jm, None, ini, [control], jm.prop, times, write=False)
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    cs = jforward._stack_controls(jm, [control])
    prop = jm.prop_to_dict(jm.prop)
    _, jtraj, _ = jforward.integrate_pure(jm, state0, cs, prop, times)

    tfin, info = forward.integrate(tm, None, state0, [{"qin": np.array([50.0])}], tm.prop,
                                   times, write=False)
    _, ttraj, _ = forward.integrate_pure(tm, state0, cs, tm.prop, times)
    return times, (jfin, jtraj), (tfin, ttraj, info), (cs, prop)


def test_wra_parts_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n_junc2 = (N_TUBE // 2 + 1) * 2
    prop = {
        "length": np.array([17.3]), "area": rng.uniform(0.3, 6.0, N_TUBE),
        "proploss": rng.uniform(0.9, 1.0, N_TUBE), "rhoac": np.array([1.225e-3]),
        "soundspeed": np.array([3.43e4]), "rrad": np.ones(1), "lrad": np.ones(1),
    }
    pinc, pref = rng.standard_normal(n_junc2), rng.standard_normal(n_junc2)
    q = rng.standard_normal(1) * 100
    jh, jf, jc = jac.make_wra_parts(N_TUBE)
    th, tf, tc = ac.make_wra_parts(N_TUBE)
    jp = {k: jnp.asarray(v) for k, v in prop.items()}
    tp = {k: torch.as_tensor(v) for k, v in prop.items()}
    j1 = jh(jnp.asarray(pinc), jnp.asarray(pref), jp)
    t1 = th(torch.as_tensor(pinc), torch.as_tensor(pref), tp)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-13, atol=0)
    jout = jf(j1, jnp.asarray(pinc), jnp.asarray(pref), jnp.asarray(q), jp)
    tout = tf(t1, torch.as_tensor(pinc), torch.as_tensor(pref), torch.as_tensor(q), tp)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=0)
    for a, b in zip(tc(t1, tp), jc(j1, jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=0)


def test_dt_locked(tracts):
    jm, tm = tracts
    assert tm.dt == jm.dt
    np.testing.assert_allclose(tm.dt, (2 * 17.0 / N_TUBE) / 340e2, rtol=1e-15)
    with pytest.raises(NotImplementedError):
        tm.dt = 1e-4
    with pytest.raises(ValueError, match="even number of tubes"):
        ac.WRAnalog(num_tube=7, device="cpu")


def test_integrate_matches_jax(runs):
    _, (jfin, jtraj), (tfin, ttraj, info), _ = runs
    for k in ("pinc", "pref"):
        np.testing.assert_allclose(tfin[k], np.asarray(jfin[k]), rtol=1e-12, atol=0)
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]), rtol=1e-12,
                                   atol=1e-12 * np.abs(jtraj[k]).max())
    assert not info["diverged"] and "lagged_fallback_steps" not in info
    # the wave reaches the mouth: the radiated pressure is not zero
    assert np.abs(np.asarray(jtraj["pinc"] + jtraj["pref"])[:, -1]).max() > 0


@pytest.mark.parametrize("name", ["RmsRadiatedPressure", "AcousticPower"])
def test_functional_matches_jax(name, runs, tracts):
    import jax.numpy as jnp

    jm, tm = tracts
    times, (_, jtraj), (_, ttraj, _), (cs, prop) = runs
    jval = getattr(jfac, name)(jm).eval_traj(
        {k: jnp.asarray(v) for k, v in jtraj.items()}, jnp.asarray(times[1:]),
        {k: jnp.asarray(v) for k, v in cs.items()}, {k: jnp.asarray(v) for k, v in prop.items()})
    tval = getattr(fac, name)(tm).eval_traj(
        ttraj, torch.as_tensor(times[1:]), {k: torch.as_tensor(v) for k, v in cs.items()},
        {k: torch.as_tensor(v) for k, v in prop.items()})
    assert float(jval) > 0
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-12)


def test_impedance_matches_jax(tracts):
    jm, tm = tracts
    jz = jac.input_and_output_impedance(jm, n=256)
    tz = ac.input_and_output_impedance(tm, n=256)
    for a, b in zip(tz, jz):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max())
