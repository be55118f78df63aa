"""
The port's ``forward.integrate`` and its surroundings (statefile, windows,
certification, divergence flags, ``integrate_extend``, ``integrate_step``)
against the JAX package's on the small explicit-FSI model in f64, and the
captured time step (``step_graph``) run uncaptured on the CPU against the
eager loop, bit for bit.
"""

import importlib
import sys
import warnings

import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward, statefile as jsf
from vf_fem_tpu_torch import forward as tforward, statefile as tsf, step_graph
from vf_fem_tpu_torch.equations import newmark
from vf_fem_tpu_torch.models.transient import StepCoefs, solver_params

from port_fixtures import (HEADLINE_SMALL, jax_vf_model, newmark_gap as _newmark_gap,
                           port_inputs, port_vf_model)

DT = 2.0 ** -13  # times n * DT are exact, so a resumed run sees the same dts
N_STEPS = 12
CONTROLS = ({"psub": 8000.0}, {"psub": 8500.0}, {"psub": 9000.0})
# the fields the Newmark relations form from u: in the adaptive runs each
# package's dense-solve rounding in u (a few 1e-14 of max|u|) reaches them
# scaled by 2/dt and 4/dt^2 (dt = 2^-13), undamped; the tests take that
# share out (_newmark_gap) and hold the rest at the usual tolerance
NEWMARK_FIELDS = ("v", "a")
# bench.py:411-434 with the refresh cut to 8 steps (tests/test_torch_btd.py)
PROD_SMALL = {"linear_solver": "btd", "btd_store_dtype": "bfloat16",
              "jacobian_refresh_steps": 8, "fixed_iterations": 3,
              "fixed_tail_residual": False, "stagnation_ratio": 0.5}


def _controls(model, values=CONTROLS):
    """Control dicts of the port model (numpy), one per entry of ``values``."""
    out = []
    for v in values:
        c = {k: np.array(x, dtype=float) for k, x in model.control.items()}
        for k, x in v.items():
            c[k][:] = x
        out.append(c)
    return out


def _jax_controls(jm, values=CONTROLS):
    """The same controls as BlockVectors of the JAX model."""
    out = []
    for v in values:
        bv = jm.control.copy()
        for k, x in v.items():
            bv[k][:] = x
        out.append(bv)
    return out


def _jax_run(jm, path, times, params, values):
    ini = jm.state0.copy()
    ini[:] = 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with jsf.StateFile(jm, path, mode="w") as f:
            fin, info = jforward.integrate(
                jm, f, ini, _jax_controls(jm, values), jm.prop, times,
                newton_solver_prm=params,
            )
    return fin, info


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's runs, each writing a statefile: adaptive defaults
    with three held-last controls; the same with the third control NaN
    (one compile for both); the headline settings, 28 steps."""
    d = tmp_path_factory.mktemp("jax")
    jm = jax_vf_model("KelvinVoigtWEpithelium")
    times = DT * np.arange(N_STEPS + 1)
    runs = {"adaptive": (str(d / "adaptive.h5"), times, {}, CONTROLS)}
    nan = CONTROLS[:2] + ({"psub": np.nan},)
    runs["diverged"] = (str(d / "diverged.h5"), times, {}, nan)
    runs["headline"] = (str(d / "headline.h5"), 1e-4 * np.arange(29),
                        {**HEADLINE_SMALL, "assembly": "plain"}, CONTROLS[:1])
    out = {}
    for name, (path, t, params, values) in runs.items():
        out[name] = (path, t, params, values) + _jax_run(jm, path, t, params, values)
    return jm, out


@pytest.fixture(scope="module")
def tmodel():
    return port_vf_model("KelvinVoigtWEpithelium")


def _port_run(tm, path, times, params, values, **kw):
    ini = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if path is None:
            return tforward.integrate(tm, None, ini, _controls(tm, values), tm.prop, times,
                                      newton_solver_prm=params, write=False, **kw)
        with tsf.StateFile(tm, path, mode="w") as f:
            return tforward.integrate(tm, f, ini, _controls(tm, values), tm.prop, times,
                                      newton_solver_prm=params, **kw)


def _read(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("run", ["adaptive", "headline"])
def test_integrate_matches_jax(jax_runs, tmodel, tmp_path, run):
    """Port and JAX ``integrate``, both writing statefiles: every state row
    within rtol 1e-9 (atol 1e-12 of the field's max; in the adaptive run
    v and a once the share of u's gap that the Newmark relations carry into
    them is taken out), Newton counts exact, times, controls (held last),
    props and mesh equal; the same ``last_info``."""
    _, runs = jax_runs
    jpath, times, params, values, jfin, jinfo = runs[run]
    path = str(tmp_path / "port.h5")
    tparams = {**params, "assembly": "banded"} if params else params
    fin, info = _port_run(tmodel, path, times, tparams, values)
    port, jax = _read(path), _read(jpath)
    assert sorted(port) == sorted(jax)
    if run == "adaptive":
        gap = _newmark_gap(port["state/u"] - jax["state/u"], 0.0, 0.0, DT)
        for k in NEWMARK_FIELDS:
            port[f"state/{k}"] = port[f"state/{k}"] - gap[k]
    for name, ref in jax.items():
        if name.startswith("state/"):
            np.testing.assert_allclose(port[name], ref, rtol=1e-9,
                                       atol=1e-12 * np.abs(ref).max(), err_msg=name)
        elif name in ("solver_info/abs_err", "solver_info/rel_err"):
            continue  # residual norms at the rounding floor
        else:
            np.testing.assert_array_equal(port[name], ref, err_msg=name)
    np.testing.assert_array_equal(info["all"]["num_iter"], np.asarray(jinfo["all"]["num_iter"]))
    for k in ("u", "q", "p"):
        np.testing.assert_allclose(fin[k], np.asarray(jfin[k]), rtol=1e-9,
                                   atol=1e-12 * np.abs(np.asarray(jfin[k])).max())
    assert (info["diverged"], info["uncertified_steps"], info["num_iter"]) == (
        jinfo["diverged"], jinfo["uncertified_steps"], jinfo["num_iter"])


def test_diverged_run_is_flagged_as_jax(jax_runs, tmodel):
    """A control that turns NaN at step 2 makes the flow NaN there and every
    solid residual from step 3 on (the solid sees the previous step's
    pressure): ``diverged`` and ``diverged_step`` as the JAX run's, with
    the same RuntimeWarning."""
    _, runs = jax_runs
    _, times, params, values, _, jinfo = runs["diverged"]
    ini = {k: np.zeros_like(v) for k, v in tmodel.state0.items()}
    with pytest.warns(RuntimeWarning, match="non-finite solver residual first at step 3"):
        _, info = tforward.integrate(tmodel, None, ini, _controls(tmodel, values),
                                     tmodel.prop, times, write=False)
    assert jinfo["diverged"] and jinfo["diverged_step"] == 3
    assert (info["diverged"], info["diverged_step"]) == (True, 3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_integrate_extend_continues_the_run(jax_runs, tmodel, tmp_path, writer):
    """``integrate_extend`` from the last row of a port-written or a
    JAX-written file continues as one uninterrupted port run: bit for bit
    after a port-written file, within ``test_integrate_matches_jax``'s
    tolerances after a JAX-written one; the file grows by the new rows."""
    _, runs = jax_runs
    jpath, times, params, values, _, _ = runs["adaptive"]
    n_more = 5
    whole = DT * np.arange(N_STEPS + n_more + 1)
    state0, _, prop = port_inputs(tmodel)
    cs = tforward._stack_controls(tmodel, _controls(tmodel, values))
    _, ref, ref_info = tforward.integrate_pure(tmodel, state0, cs, prop, whole, params)
    if writer == "port":
        path = str(tmp_path / "port.h5")
        _port_run(tmodel, path, times, params, values)
    else:
        path = jpath
    last = _controls(tmodel, values[-1:])
    with tsf.StateFile(tmodel, path, mode="a") as f:
        fin, info = tforward.integrate_extend(tmodel, f, last, DT * np.arange(n_more + 1),
                                              newton_solver_prm=params)
        assert f.size == N_STEPS + n_more + 1
        np.testing.assert_array_equal(f.get_times(), whole)
        rows = f.get_state_trajectory()
    # rows N_STEPS .. of the file against the uninterrupted run's
    got = {k: rows[k][N_STEPS:] for k in ref}
    want = {k: t.numpy()[N_STEPS - 1:] for k, t in ref.items()}
    if writer == "jax":
        start = {k: got[k][0] - want[k][0] for k in NEWMARK_FIELDS}
        gap = _newmark_gap(got["u"] - want["u"], start["v"], start["a"], DT)
        for k in NEWMARK_FIELDS:
            got[k] = got[k] - gap[k]
    for k in ref:
        if writer == "port":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(fin[k], want[k][-1], err_msg=k)
        else:
            np.testing.assert_allclose(got[k][1:], want[k][1:], rtol=1e-9,
                                       atol=1e-12 * np.abs(want[k]).max(), err_msg=k)
    np.testing.assert_array_equal(info["num_iter"], ref_info.num_iter.numpy()[N_STEPS:])


@pytest.mark.parametrize("params", [{}, HEADLINE_SMALL], ids=["adaptive", "headline"])
def test_windowed_equals_unwindowed(tmodel, params):
    """Windows of 10 steps over 21 (twice the headline refresh window, so
    that the refresh schedule restarts where it would anyway, and a
    one-step remainder) give the unwindowed run's trajectory and infos bit
    for bit, on the host."""
    state0, _, prop = port_inputs(tmodel)
    cs = tforward._stack_controls(tmodel, _controls(tmodel))
    times = DT * np.arange(22)
    fin, traj, infos = tforward._integrate_windowed(tmodel, state0, cs, prop, times, params)
    wfin, wtraj, winfos = tforward._integrate_windowed(tmodel, state0, cs, prop, times,
                                                       params, window=10)
    for k, t in traj.items():
        assert isinstance(wtraj[k], np.ndarray)
        np.testing.assert_array_equal(wtraj[k], t.numpy(), err_msg=k)
        assert torch.equal(wfin[k], fin[k])
    for a, b in zip(winfos, infos):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("times", [[], [0.0], [1.0, 0.5], [0.0, 1e-4]],
                         ids=["empty", "one", "backwards", "ok"])
def test_validate_times_as_jax(times):
    """The same errors, with the same messages, as the JAX package."""
    try:
        want = jforward.validate_times(times)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tforward.validate_times(times)
        assert str(got.value) == str(err)
    else:
        np.testing.assert_array_equal(tforward.validate_times(times), want)


def test_time_varying_controls_are_held_last(tmodel, tmp_path):
    """Three controls over 6 steps run as the six controls with the last
    repeated, bit for bit; the statefile holds one control row a time
    point, the last one held."""
    times = DT * np.arange(7)
    path = str(tmp_path / "held.h5")
    fin, _ = _port_run(tmodel, path, times, {}, CONTROLS)
    fin6, _ = _port_run(tmodel, None, times, {}, CONTROLS + CONTROLS[-1:] * 3)
    for k in fin:
        np.testing.assert_array_equal(fin[k], fin6[k], err_msg=k)
    psub = _read(path)["control/psub"][:, 0]
    np.testing.assert_array_equal(psub, [8000, 8000, 8500, 9000, 9000, 9000, 9000])


def _infos(rel, absr, dtype):
    return {"num_iter": np.full(len(rel), 2), "rel_err": np.array(rel, dtype=dtype),
            "abs_err": np.array(absr, dtype=dtype)}


@pytest.mark.parametrize("case", [
    ({"fixed_iterations": 2}, [1e-7, 5e-6, 2e-6], [1.0, 1.0, 1.0], np.float64),
    ({"fixed_iterations": 2}, [1e-4, 4e-3, 2e-3], [1.0, 1.0, 1.0], np.float32),
    ({"fixed_iterations": 2}, [5e-6, 5e-6, np.nan], [1e-9, 1.0, np.nan], np.float64),
    ({"fixed_iterations": 3, "fixed_certify_rel_err": 1e-8}, [1e-7, 1e-9], [1.0, 1.0],
     np.float64),
    ({"fixed_iterations": 2, "absolute_tolerance": 1e-3}, [1e-2, 1e-2], [1e-4, 1.0],
     np.float64),
    ({}, [1.0, 1.0], [1.0, 1.0], np.float64),
], ids=["f64", "f32", "abs-exempt-and-nan", "own-threshold", "own-abs-tol", "adaptive"])
def test_certify_fixed_iterations_as_jax(case):
    """The number of uncertified steps and the warning, as the JAX
    package's on the same numpy infos."""
    params, rel, absr, dtype = case
    info = _infos(rel, absr, dtype)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jforward.certify_fixed_iterations(params, info)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tforward.certify_fixed_iterations(params, info)
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_fixed_iteration_certification_guard():
    """As ``tests/test_forward.py``'s guard: fixed-1 stops above the
    certification threshold and warns, fixed-4 certifies every step."""
    model = port_vf_model()
    times = 2e-5 * np.arange(17)
    ini = {k: np.zeros_like(v) for k, v in model.state0.items()}
    with pytest.warns(RuntimeWarning, match="certification threshold"):
        _, info = tforward.integrate(model, None, ini, [model.control], model.prop, times,
                                     write=False, newton_solver_prm={
                                         "fixed_iterations": 1, "jacobian_refresh_steps": 8})
    assert info["uncertified_steps"] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, info = tforward.integrate(model, None, ini, [model.control], model.prop, times,
                                     write=False, newton_solver_prm={
                                         "fixed_iterations": 4, "jacobian_refresh_steps": 8})
    assert info["uncertified_steps"] == 0 and not info["diverged"]


def test_integrate_step_is_one_step_pure(tmodel):
    """``integrate_step`` is one ``step_pure`` of the model, bit for bit,
    returned as numpy dicts."""
    state0, _, prop = port_inputs(tmodel)
    ctrl = _controls(tmodel)[1]
    state, info = tforward.integrate_step(tmodel, state0, ctrl, prop, DT)
    tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in state0.items()}
    ref, rinfo = tmodel.step_pure(tensors, {k: torch.as_tensor(v) for k, v in ctrl.items()},
                                  {k: torch.as_tensor(v) for k, v in prop.items()}, DT)
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)
    assert info == {k: v.item() for k, v in zip(("num_iter", "abs_err", "rel_err"), rinfo)}


def test_forward_needs_no_h5py(monkeypatch, tmodel, tmp_path):
    """``forward`` and ``statefile`` import, and ``integrate(model, None,
    ...)`` runs, where h5py cannot be imported (as on a machine without
    it); opening a statefile there raises ImportError."""
    import vf_fem_tpu_torch

    monkeypatch.setitem(sys.modules, "h5py", None)
    for name in ("forward", "statefile"):
        monkeypatch.setattr(vf_fem_tpu_torch, name, getattr(vf_fem_tpu_torch, name))
        monkeypatch.delitem(sys.modules, f"vf_fem_tpu_torch.{name}")
    fwd = importlib.import_module("vf_fem_tpu_torch.forward")
    sf = importlib.import_module("vf_fem_tpu_torch.statefile")
    assert fwd is not tforward
    ini = {k: np.zeros_like(v) for k, v in tmodel.state0.items()}
    _, info = fwd.integrate(tmodel, None, ini, [tmodel.control], tmodel.prop,
                            DT * np.arange(3), write=False)
    assert info["num_iter"] > 0 and not info["diverged"]
    with pytest.raises(ImportError):
        sf.StateFile(tmodel, str(tmp_path / "x.h5"), mode="w")


# -- the captured step, uncaptured on the CPU ------------------------------------------


def _uneven_times(n_steps):
    times = 1e-4 * np.arange(n_steps + 1)
    times[3:] += 2e-6 * np.arange(n_steps - 2)  # dt varies from step 3
    return times


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("config", ["headline", "btd"])
def test_capturable_step_uncaptured_equals_eager(config, dtype):
    """The step the card captures (static buffers, a device step counter,
    the Newmark coefficient and held-last control tables) run uncaptured on
    the CPU gives the eager loop's trajectory, infos and final state bit
    for bit, with dt varying and three controls."""
    if config == "headline":
        model = port_vf_model("KelvinVoigtWEpithelium", dtype=dtype)
        params, n_steps = {**HEADLINE_SMALL, "assembly": "banded"}, 28
    else:
        model = port_vf_model("KelvinVoigtWEpithelium", 10, 5, dtype=dtype, reorder="rcm")
        params, n_steps = {**PROD_SMALL, "assembly": "banded"}, 20
    state0, _, prop = port_inputs(model)
    cs = tforward._stack_controls(model, _controls(model))
    times = _uneven_times(n_steps)
    fin, traj, infos = tforward._integrate_eager(model, state0, cs, prop, times, params)
    gfin, gtraj, ginfos = step_graph.integrate(model, state0, cs, prop, times,
                                               solver_params(params))
    for k in traj:
        assert torch.equal(gtraj[k], traj[k]), k
        assert torch.equal(gfin[k], fin[k]), k
    for a, b in zip(ginfos, infos):
        assert torch.equal(a, b)
    assert model.solid.predictor_counts["formed"] == 2 + 1  # eager 2, then 1


def test_capturable_step_in_short_chunks_equals_eager(monkeypatch):
    """Chunks of 3 steps, which end inside and across refresh windows, give
    the eager loop's trajectory and infos bit for bit: the host's copies of
    rows in and out between chunks lose nothing."""
    monkeypatch.setattr(step_graph, "CHUNK", 3)
    model = port_vf_model("KelvinVoigtWEpithelium")
    params = {**HEADLINE_SMALL, "assembly": "banded"}
    state0, _, prop = port_inputs(model)
    cs = tforward._stack_controls(model, _controls(model))
    times = _uneven_times(13)
    fin, traj, infos = tforward._integrate_eager(model, state0, cs, prop, times, params)
    gfin, gtraj, ginfos = step_graph.integrate(model, state0, cs, prop, times,
                                               solver_params(params))
    assert all(torch.equal(gtraj[k], traj[k]) and torch.equal(gfin[k], fin[k]) for k in traj)
    assert all(torch.equal(a, b) for a, b in zip(ginfos, infos))


def test_step_buffers_copy_the_callers_properties():
    """The buffers take copies of a run's properties: loading another run's
    writes into those copies, never into the first caller's tensors."""
    model = port_vf_model("KelvinVoigtWEpithelium")
    state0, _, prop = port_inputs(model)
    first = {k: torch.tensor(v) for k, v in prop.items()}
    kept = {k: v.clone() for k, v in first.items()}
    second = {k: v * 1.5 for k, v in first.items()}
    buf = step_graph.StepBuffers(model, solver_params(HEADLINE_SMALL))
    buf.load(state0, first)
    assert all(buf.prop[k] is not first[k] for k in first)
    buf.load(state0, second)
    assert all(torch.equal(first[k], kept[k]) for k in first)
    assert all(torch.equal(buf.prop[k], second[k]) for k in second)


def test_coefficient_table_is_the_eager_loops_floats():
    """Row n of the table is ``coefficients(dt_n, dt_{n+1})`` of the eager
    loop's Python floats (the last step's predictor over its own dt)."""
    times = _uneven_times(6)
    dts = [float(x) for x in np.diff(times)]
    table = step_graph.coefficient_table(np.diff(times))
    for n, row in enumerate(table):
        assert row.tolist() == list(newmark.coefficients(dts[n], dts[min(n + 1, 5)]))


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_res_u_with_a_coefficient_row(dtype, banded):
    """``res_u`` multiplying by the 0-d tensors of a coefficient row gives
    the bits of the Python-float expressions, f64 and f32 (in f32 both
    round each coefficient to float before the product)."""
    model = port_vf_model("KelvinVoigtWEpithelium", dtype=dtype)
    solid = model.solid
    rng = np.random.default_rng(3)
    s0 = {k: torch.tensor(1e-3 * rng.standard_normal(solid.ndof), dtype=dtype)
          for k in ("u", "v", "a")}
    u1 = s0["u"] + 1e-4
    prop = {k: torch.tensor(model.prop[k], dtype=dtype) for k in model._solid_prop_keys}
    ctrl = {"p1": torch.full((solid.nvert,), 500.0, dtype=dtype)}
    for dt in (1e-4, 3.7e-5, 2.0 ** -13):
        row = torch.tensor(newmark.coefficients(dt, 2e-4), dtype=torch.float64)
        assert torch.equal(solid.res_u(u1, s0, ctrl, prop, StepCoefs(row, dtype), banded),
                           solid.res_u(u1, s0, ctrl, prop, dt, banded))


def test_newmark_row_reference_is_the_float_version():
    """The plain K5 of a coefficient row (rounded to the vectors' dtype)
    equals the plain K5 of the same steps as floats, bit for bit, f64 and
    f32; a row of another dtype is refused."""
    from vf_fem_tpu_torch import ops

    rng = np.random.default_rng(9)
    for dtype in (torch.float64, torch.float32):
        args = [torch.tensor(rng.standard_normal(77), dtype=dtype) for _ in range(4)]
        for dt, dtp in ((1e-4, 7.5e-5), (3.3e-5, 3.3e-5)):
            row = ops.newmark_row(newmark.coefficients(dt, dtp), dtype, "cpu")
            got = ops.newmark_update_coefs(*args, row)
            want = ops.newmark_update(*args, dt, dt_next=dtp)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="row of"):
        ops.newmark_update_coefs(*args, row.double())
