"""
The two-way coupled fluid-solid-acoustic model (``models.fsai``) of the
port against the JAX package on the CPU in f64, on the models of
``tests/test_fsai.py`` (KelvinVoigt + BernoulliSmoothMinSep on the
vocal-fold mesh, a WRA tract of 12 tubes, the contact plane below the
midline):

- ``solve_flow_root`` against the JAX function on seeded Bernoulli-like
  source laws (values within 1e-12, the same ``bracketed``), and on the
  root-free map of ``tests/test_fsai.py:307-321`` (no bracket, the lagged
  fallback);
- ``golden_fsai_explicit.npz`` through the port (160 steps; the JAX
  test's tolerances, ``tests/test_fsai.py:188-201``), with no lagged step;
- the tract's feedback changes the glottal flow against the uncoupled FSI
  run at the same dt (over 40 steps);
- carried factors (refresh 8) against the exact Jacobian (rtol 1e-8);
- the envelope guard's warning, and ``lagged_fallback_steps`` counted as
  the JAX package counts them;
- the statefile round trip (``pinc``/``pref`` included) and
  ``integrate_extend`` against one longer run;
- the step the card captures (``step_graph``), run uncaptured on the CPU
  in chunks of 3 steps, equals the eager loop bit for bit, ``bracketed``
  included.

Gradients are ``tests/test_torch_fsai_grad.py``'s, tangents
``tests/test_torch_fsai_tangents.py``'s, the M5 golden
``tests/test_torch_fsai_m5.py``'s.
"""

import warnings

import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu_torch import forward, step_graph
from vf_fem_tpu_torch.models.fsai import FSAISolveInfo, solve_flow_root
from vf_fem_tpu_torch.models.transient import solver_params

from port_fixtures import HEADLINE_SMALL, port_fsai_model, port_inputs
from test_fsai import GOLDEN, make_fsai_model


@pytest.fixture(scope="module")
def small():
    """The 8 x 4 model of tests/test_fsai.py in both packages."""
    jm = make_fsai_model(nx=8, ny=4)
    return jm, port_fsai_model(jm, nx=8, ny=4)


@pytest.fixture(scope="module")
def golden_run():
    """The port's run of golden_fsai_explicit.npz (10 x 5, 160 steps)."""
    data = np.load(GOLDEN)
    tm = port_fsai_model(make_fsai_model(), nx=10, ny=5)
    times = tm.dt * np.arange(int(data["n_steps"]) + 1)
    return data, tm, times, forward.integrate_pure(tm, *port_inputs(tm), times)


def _bernoulli_source(lib, z, b2, psub=8000.0, area=0.05, rho=1.1225e-3):
    """A glottal source law against the tract: ``q(psup)`` of the
    Bernoulli orifice at ``psup = z q + 2 b2`` (``lib``: jax.numpy or
    torch)."""

    def fluid_at(q):
        dp = psub - (z * q + 2.0 * b2)
        qn = lib.sign(dp) * area * lib.sqrt(2.0 / rho * lib.abs(dp))
        return {"q": qn.reshape((1,)), "p": lib.stack([dp, 0.5 * dp])}

    return fluid_at


@pytest.mark.parametrize("case", [(40.0, 500.0, 120.0, True), (5.0, -300.0, 0.0, True),
                                  (400.0, 2000.0, 1e5, False)],
                         ids=["near", "loose", "far"])
def test_solve_flow_root_matches_jax(case):
    """Values and ``bracketed`` as the JAX function's, with the default
    budget, for a previous flow near the root, from rest and far above it
    (the expansion phase, where 20 bisections of the expanded interval
    leave the polished root short of 1e-12 in both packages)."""
    import jax.numpy as jnp

    from vf_fem_tpu.models.fsai import solve_flow_root as jsolve

    z, b2, q0, converged = case
    jout, jbr = jsolve(_bernoulli_source(jnp, jnp.asarray(z), jnp.asarray(b2)),
                       jnp.asarray([q0]))
    tout, tbr = solve_flow_root(
        _bernoulli_source(torch, torch.tensor(z, dtype=torch.float64),
                          torch.tensor(b2, dtype=torch.float64)),
        torch.tensor([q0], dtype=torch.float64))
    assert bool(tbr) == bool(jbr) is True
    for k in ("q", "p"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-12)
    if not converged:
        return
    # the root: q = Q(psup(q))
    q = float(tout["q"])
    dp = 8000.0 - (z * q + 2.0 * b2)
    np.testing.assert_allclose(q, np.sign(dp) * 0.05 * np.sqrt(2 / 1.1225e-3 * abs(dp)),
                               rtol=1e-12)


def test_solve_flow_root_reports_bracket_failure():
    """A root-free map (f(q) = q + 1) comes back ``bracketed`` False with
    the fluid evaluated at the previous flow, as in the JAX package."""
    import jax.numpy as jnp

    from vf_fem_tpu.models.fsai import solve_flow_root as jsolve

    def fluid_at(lib):
        return lambda q: {"q": (q + 1.0).reshape((1,)), "p": lib.zeros((3,), dtype=q.dtype)}

    jout, jbr = jsolve(fluid_at(jnp), jnp.asarray([2.5]), n_expand=4, n_bisect=8)
    tout, tbr = solve_flow_root(fluid_at(torch), torch.tensor([2.5], dtype=torch.float64),
                                n_expand=4, n_bisect=8)
    assert not bool(tbr) and not bool(jbr)
    np.testing.assert_allclose(tout["q"].numpy(), [3.5], rtol=1e-12)
    np.testing.assert_allclose(tout["q"].numpy(), np.asarray(jout["q"]), rtol=1e-15)


def test_golden_fsai_explicit(golden_run):
    data, _, _, (_, traj, infos) = golden_run
    np.testing.assert_allclose(traj["u"].numpy()[::8], data["u"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(traj["q"].numpy().ravel(), data["q"], rtol=1e-8)
    np.testing.assert_allclose(traj["pref"].numpy()[-1], data["pref_final"],
                               rtol=1e-8, atol=1e-10)
    assert isinstance(infos, FSAISolveInfo) and bool(infos.bracketed.all())


def test_two_way_coupling_changes_phonation(golden_run):
    """The tract feeds back into the fluid: the coupled run's glottal flow
    differs from the uncoupled FSI run's (psup = 0, same solid and fluid,
    same dt) over the first 40 steps (the 12-tube tract's reflections
    return after ~12), and the tract is driven."""
    _, tm, times, (_, traj, _) = golden_run
    q = traj["q"].numpy().ravel()
    assert np.all(np.isfinite(q)) and np.abs(q).max() > 1.0
    prad = (traj["pinc"] + traj["pref"]).numpy()[:, -1]
    assert np.abs(prad).max() > 1e-3
    fsi = tm.fsi
    _, traj_u, _ = forward.integrate_pure(fsi, *port_inputs(fsi), times[:41])
    q, q_unc = q[:40], traj_u["q"].numpy().ravel()
    assert np.abs(q - q_unc).max() > 1e-6 * max(np.abs(q).max(), 1.0)


def test_stale_matches_exact(small):
    _, tm = small
    times = tm.dt * np.arange(33)
    _, t0, _ = forward.integrate_pure(tm, *port_inputs(tm), times, {"jacobian_refresh_steps": 1})
    _, t1, _ = forward.integrate_pure(tm, *port_inputs(tm), times, {"jacobian_refresh_steps": 8})
    for k in ("u", "pref"):
        np.testing.assert_allclose(t1[k].numpy(), t0[k].numpy(), rtol=1e-8, atol=1e-12)


def test_envelope_guard_warns_and_counts(small):
    """A contact plane above the midline warns at ``integrate``'s entry;
    every FSAI run reports ``lagged_fallback_steps`` (0 in the envelope),
    and steps without a bracket are counted and warned about as the JAX
    package's ``finalize_run`` does."""
    jm, tm = small
    ymax = tm.solid.residual.mesh().coords[:, 1].max()
    ini = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    times = tm.dt * np.arange(4)
    prop = {k: v.copy() for k, v in tm.prop.items()}
    prop["ycontact"][:] = ymax + 0.05  # above ymid
    with pytest.warns(RuntimeWarning, match="outside the supported envelope"):
        _, info = forward.integrate(tm, None, ini, [tm.control], prop, times, write=False)
    assert "lagged_fallback_steps" in info
    assert tm.check_envelope()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, info = forward.integrate(tm, None, ini, [tm.control], tm.prop, times, write=False)
    assert info["lagged_fallback_steps"] == 0

    # two of four steps unbracketed, through both packages' bookkeeping
    from vf_fem_tpu.models.fsai import FSAISolveInfo as JInfo

    fields = (np.full(4, 2), np.full(4, 1e-9), np.full(4, 1e-10),
              np.array([True, False, True, False]))
    _, traj, _ = forward.integrate_pure(tm, *port_inputs(tm), times)
    counts = []
    for mod, infos, model in ((forward, FSAISolveInfo(*map(torch.as_tensor, fields)), tm),
                              (jforward, JInfo(*fields), jm)):
        with pytest.warns(RuntimeWarning, match="could not"):
            _, last = mod.finalize_run(model, None, ini, [model.control], model.prop, times,
                                       None, None, ini, {k: v.numpy() for k, v in traj.items()},
                                       infos, write=False)
        counts.append(last["lagged_fallback_steps"])
    assert counts == [2, 2]


def test_statefile_roundtrip_and_extend(small, tmp_path):
    """FSAI runs persist through the statefile, the tract's blocks
    included, and resume: 8 steps then 4 more equal one 12-step run."""
    from vf_fem_tpu_torch import statefile as sf

    _, tm = small
    ini = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    times = tm.dt * np.arange(9)
    path = str(tmp_path / "fsai.h5")
    with sf.StateFile(tm, path, mode="w") as f:
        fin, info = forward.integrate(tm, f, ini, [tm.control], tm.prop, times)
        assert f.size == len(times) and info["lagged_fallback_steps"] == 0
        stored = f.get_state(f.size - 1)
        for k in ("u", "q", "pinc", "pref"):
            np.testing.assert_allclose(stored[k], fin[k], rtol=1e-12, atol=1e-14)
        fin2, _ = forward.integrate_extend(tm, f, [tm.control], tm.dt * np.arange(5))
        assert f.size == len(times) + 4
    fin_full, _ = forward.integrate(tm, None, ini, [tm.control], tm.prop,
                                    tm.dt * np.arange(13), write=False)
    for k in ("u", "pinc", "pref"):
        np.testing.assert_allclose(fin2[k], fin_full[k], rtol=1e-9, atol=1e-12)


def test_captured_step_uncaptured_equals_eager(small, monkeypatch):
    """The FSAI step the card captures, on the step graph's buffers
    uncaptured on the CPU in chunks of 3 steps, gives the eager loop's
    trajectory (``pinc``/``pref`` included), infos (``bracketed``
    included) and final state bit for bit."""
    monkeypatch.setattr(step_graph, "CHUNK", 3)
    _, tm = small
    params = solver_params({**HEADLINE_SMALL, "assembly": "banded"})
    state0, cs, prop = port_inputs(tm)
    times = tm.dt * np.arange(14)
    fin, traj, infos = forward._integrate_eager(tm, state0, cs, prop, times, params)
    gfin, gtraj, ginfos = step_graph.integrate(tm, state0, cs, prop, times, params)
    assert set(traj) == set(tm.state0) and isinstance(ginfos, FSAISolveInfo)
    assert all(torch.equal(gtraj[k], traj[k]) and torch.equal(gfin[k], fin[k]) for k in traj)
    assert all(torch.equal(a, b) for a, b in zip(ginfos, infos))
    assert ginfos.bracketed.dtype == torch.bool and bool(ginfos.bracketed.all())
