"""
The port's trajectory functionals (``vf_fem_tpu_torch.functional``), the
per-step residual diagnostics (``stepfunctional``) and the functional
algebra against the JAX package's on the CPU in f64, on one trajectory
written by the JAX package's ``forward.integrate`` (KelvinVoigt +
BernoulliSmoothMinSep, nx=8, ny=4, 24 steps at dt = 2e-5, as
``tests/test_functional.py``) and read by both packages' statefiles: each
value to rtol 1e-12, each derivative (``eval_dstate`` at the first and
last stored state, ``eval_dprops``, ``eval_dtimes``) per key to 1e-10 of
its largest JAX entry.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu import statefile as jsf
from vf_fem_tpu.functional import fluid as jfl, fsi as jfsi, solid as jsl
from vf_fem_tpu.residuals import fluid as jflr
from vf_fem_tpu.stepfunctional import make_residuals as jmake_residuals
from vf_fem_tpu_torch import forward as tforward
from vf_fem_tpu_torch import statefile as tsf
from vf_fem_tpu_torch.functional import fluid as tfl, fsi as tfsi, solid as tsl
from vf_fem_tpu_torch.stepfunctional import make_residuals

from fixture_models import make_vf_fsi_model
from port_fixtures import port_smooth_model

N_STEPS = 24
DT = 2e-5

# (JAX module, port module, class name) of every ported functional that
# the model's properties define
FUNCTIONALS = [(jsl, tsl, n) for n in (
    "PeriodicError", "UPeriodicError", "VPeriodicError", "APeriodicError",
    "PeriodicEnergyError", "FinalDisplacementNorm", "FinalVelocityNorm",
    "FinalSurfaceDisplacementNorm", "ElasticEnergyDifference", "KVDampingWork",
    "KV3DDampingWork", "GlottalWidthErrorNorm")] + [(jfl, tfl, n) for n in (
    "FinalPressureNorm", "FinalFlowRateNorm", "AvgSubglottalPower",
    "AvgAcousticPower", "SubglottalWork")] + [(jfsi, tfsi, n) for n in (
    "TransferWorkbyVelocity", "TransferWorkbyDisplacementIncrement")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX model, port model, path of the JAX package's statefile)."""
    jm = make_vf_fsi_model(FluidResidual=jflr.BernoulliSmoothMinSep, nx=8, ny=4)
    tm = port_smooth_model(jm)
    path = str(tmp_path_factory.mktemp("funcs") / "run.h5")
    ini = jm.state0.copy()
    ini[:] = 0.0
    with jsf.StateFile(jm, path, mode="w") as f:
        jforward.integrate(jm, f, ini, [jm.control], jm.prop, DT * np.arange(N_STEPS))
    return jm, tm, path


def _constants(func, size):
    if "gw_meas" in func.constants:
        func.constants["gw_meas"] = 0.02 + 1e-3 * np.sin(np.arange(size))
    if "n_start" in func.constants:
        func.constants["n_start"] = 2


def _close(p, j, rtol, what):
    """max|p - j| <= rtol max|j|; a JAX derivative that is exactly zero
    (the functional does not read that key) must be zero in the port."""
    p, j = np.asarray(p, dtype=np.float64), np.asarray(j, dtype=np.float64)
    assert p.shape == j.shape, what
    scale = np.abs(j).max() if j.size else 0.0
    assert np.abs(p - j).max(initial=0.0) <= rtol * scale, (
        f"{what}: {np.abs(p - j).max():.3e} of {scale:.3e}")


@pytest.mark.parametrize("jmod,tmod,name", FUNCTIONALS,
                         ids=[n for _, _, n in FUNCTIONALS])
def test_functional_matches_jax(run, jmod, tmod, name):
    jm, tm, path = run
    jfunc, tfunc = getattr(jmod, name)(jm), getattr(tmod, name)(tm)
    with jsf.StateFile(jm, path, mode="r") as fj, tsf.StateFile(tm, path, mode="r") as ft:
        for func in (jfunc, tfunc):
            _constants(func, ft.size)
        vj, vt = jfunc(fj), tfunc(ft)
        assert np.isfinite(vt)
        np.testing.assert_allclose(vt, vj, rtol=1e-12)
        for n in (0, ft.size - 1):
            gj = dict(jfunc.eval_dstate(fj, n).sub_items())
            gt = tfunc.eval_dstate(ft, n)
            for k in gj:
                _close(gt[k], gj[k], 1e-10, f"dstate[{n}] {k}")
        gj = dict(jfunc.eval_dprops(fj).sub_items())
        gt = tfunc.eval_dprops(ft)
        for k in gj:
            _close(gt[k], gj[k], 1e-10, f"dprops {k}")
        _close(tfunc.eval_dtimes(ft), jfunc.eval_dtimes(fj), 1e-10, "dtimes")
        np.testing.assert_allclose(tfunc.eval_ddt(ft, 3), jfunc.eval_ddt(fj, 3),
                                   rtol=1e-10, atol=1e-10 * np.abs(jfunc.eval_dtimes(fj)).max())


def test_rayleigh_damping_work_matches_jax(run):
    """``RayleighDampingWork`` (its properties come with a Rayleigh-damped
    residual): ``eval_traj`` on the stored run with ``rayleigh_m`` and
    ``rayleigh_k`` added to the properties, value to rtol 1e-12."""
    jm, tm, path = run
    with tsf.StateFile(tm, path, mode="r") as ft:
        from vf_fem_tpu_torch.functional.base import _load_statefile

        traj, times, controls, props = _load_statefile(tm, ft)
    props = {**props, "rayleigh_m": np.array([3.0]), "rayleigh_k": np.array([2e-4])}
    vj = jsl.RayleighDampingWork(jm).eval_traj(
        *({k: jnp.asarray(v) for k, v in d.items()} if isinstance(d, dict) else jnp.asarray(d)
          for d in (traj, times, controls, props)))
    vt = tsl.RayleighDampingWork(tm).eval_traj(
        *({k: torch.as_tensor(v) for k, v in d.items()} if isinstance(d, dict)
          else torch.as_tensor(d) for d in (traj, times, controls, props)))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)


def test_functional_algebra_matches_jax(run):
    """Sums, differences, products, quotients and powers of functionals and
    scalars, and their derivatives, as the JAX package's."""
    jm, tm, path = run

    def combo(mod, model):
        a = mod[0].FinalDisplacementNorm(model)
        b = mod[1].FinalFlowRateNorm(model)
        return (2.0 * a + b) ** 2 / (1.0 + b) - a * 3.0

    jfunc, tfunc = combo((jsl, jfl), jm), combo((tsl, tfl), tm)
    with jsf.StateFile(jm, path, mode="r") as fj, tsf.StateFile(tm, path, mode="r") as ft:
        np.testing.assert_allclose(tfunc(ft), jfunc(fj), rtol=1e-12)
        gj = dict(jfunc.eval_dstate(fj, ft.size - 1).sub_items())
        gt = tfunc.eval_dstate(ft, ft.size - 1)
        for k in gj:
            _close(gt[k], gj[k], 1e-10, f"dstate {k}")


def test_step_residuals(run):
    """``make_residuals`` of the port: every block vanishes to its solver's
    rounding at the port's own second step; at a perturbed state (u scaled
    by 1.5 plus 1e-3) every block equals the JAX package's
    ``make_residuals`` on the same inputs (rtol 1e-10)."""
    jm, tm, _ = run
    dt = 1e-4
    zero = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    cs = {k: v[None] for k, v in tm.control.items()}
    _, traj, _ = tforward.integrate_pure(tm, zero, cs, tm.prop, dt * np.arange(3))
    state0, state1 = ({k: v[i].numpy() for k, v in traj.items()} for i in (0, 1))
    residuals = make_residuals(tm)
    r = residuals(state1, state0, tm.control, tm.prop, dt)
    assert set(r) == {"u", "v", "a", "q", "p"}
    assert r["u"] < 1e-6 and r["v"] < 1e-8 and r["a"] < 1e-8
    assert r["q"] < 1e-6 and r["p"] < 1e-6

    def bv(proto, d):
        out = proto.copy()
        for k in d:
            out[k][:] = d[k]
        return out

    bad = {**state1, "u": state1["u"] * 1.5 + 1e-3}
    r = residuals(bad, state0, tm.control, tm.prop, dt)
    rj = jmake_residuals(jm)(bv(jm.state0, bad), bv(jm.state0, state0), jm.control,
                             jm.prop, dt)
    for k in r:
        assert r[k] > 1e-3 and abs(r[k] - rj[k]) <= 1e-10 * rj[k], k
