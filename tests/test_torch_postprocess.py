"""
The port's post-processing (``vf_fem_tpu_torch.postprocess``) against the
JAX package's on the CPU in f64, on the same stored states: a 24-step run
of ``tests/test_functional.py``'s model (BernoulliSmoothMinSep, 8 x 4)
written by the JAX package's ``forward.integrate`` and read back by each
package's own ``StateFile`` (one schema).

- every measure of ``postprocess/solid.py`` and ``fluid.py`` at the last
  stored state against the JAX measure (rtol 1e-12 plus 1e-15 of the
  value's largest entry);
- ``TimeSeries`` of each against the JAX series, and the port's ``vmap``
  against its own per-state loop (rtol 1e-12 plus 1e-15 of the largest
  entry: the same arithmetic, batched);
- ``FieldStats``, ``TimeSeriesStats`` and the derived and history bases
  (``tests/test_functional.py:100-195``).
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward, statefile as jsf
from vf_fem_tpu.postprocess import TimeSeries as JTimeSeries
from vf_fem_tpu.postprocess import fluid as jpfl, solid as jpsl
from vf_fem_tpu_torch import statefile as sf
from vf_fem_tpu_torch.postprocess import TimeSeries, TimeSeriesStats
from vf_fem_tpu_torch.postprocess import fluid as pfl, solid as psl

from fixture_models import make_vf_fsi_model
from port_fixtures import port_smooth_model

MEASURES = [
    "StressI1Field", "StressI2Field", "StressI3Field", "StressVonMisesField",
    "StressHydrostaticField", "ElasticStressField", "StrainEnergy", "StrainEnergyRate",
    "PositiveStrainEnergyRate", "ContactPressureField", "ViscousDissipationField",
    "ViscousDissipationRate", "ContactAreaDensity", "XMomentum", "YMomentum",
    "MeanGlottalWidth", "MidpointGlottalWidth", "MinGlottalWidthFromSolid",
    "FSIPressure", "FluidTractionPowerDensity",
]
FLUID_MEASURES = ["FlowRate", "PressureField"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX model, port model, JAX statefile, port statefile): the same
    stored run, read by each package."""
    from vf_fem_tpu.residuals import fluid as flr

    jm = make_vf_fsi_model(FluidResidual=flr.BernoulliSmoothMinSep, nx=8, ny=4)
    # psub 8000 Ba from rest: the fold moves and the contact plane is
    # crossed by no vertex; a lower plane makes ContactPressureField and
    # ContactAreaDensity nonzero
    jm.prop["ycontact"][:] = jm.prop["ymid"][0] - 0.05
    jm.set_prop(jm.prop)
    path = str(tmp_path_factory.mktemp("post") / "run.h5")
    ini = jm.state0.copy()
    ini[:] = 0.0
    with jsf.StateFile(jm, path, mode="w") as f:
        jforward.integrate(jm, f, ini, [jm.control], jm.prop, 2e-5 * np.arange(24))
    tm = port_smooth_model(jm)
    jf = jsf.StateFile(jm, path, mode="r")
    tf = sf.StateFile(tm, path, mode="r")
    yield jm, tm, jf, tf
    jf.close()
    tf.close()


def assert_close(out, ref, rtol=1e-12, rel_atol=1e-15):
    if isinstance(ref, dict):
        assert set(out) == set(ref)
        for k in ref:
            assert_close(out[k], ref[k], rtol, rel_atol)
        return
    ref = np.asarray(ref)
    out = np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rel_atol * max(np.abs(ref).max(), 1e-300))


def _pair(run, name, module=(psl, jpsl)):
    jm, tm = run[0], run[1]
    return getattr(module[0], name)(tm), getattr(module[1], name)(jm)


@pytest.mark.parametrize("name", MEASURES)
def test_measure_matches_jax(run, name):
    jm, tm, jf, tf = run
    port, ref = _pair(run, name)
    n = tf.size - 1
    out = port(tf.get_state(n), tf.get_control(n), tf.get_prop())
    assert_close(out, ref(jf.get_state(n), jf.get_control(n), jf.get_prop()))
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("name", MEASURES)
def test_timeseries_matches_jax_and_loop(run, name):
    jm, tm, jf, tf = run
    port, ref = _pair(run, name)
    series = TimeSeries(port)
    batched = series(tf)
    assert batched.shape[0] == tf.size
    assert_close(batched, JTimeSeries(ref)(jf))
    assert_close(batched, series.assem_loop(tf, range(tf.size)))


def test_contact_is_engaged(run):
    """The run crosses the contact plane: the contact measures are not
    trivially zero."""
    _, tm, _, tf = run
    series = TimeSeries(psl.ContactAreaDensity(tm))(tf)
    assert series[-1].sum() > 0


@pytest.mark.parametrize("name", FLUID_MEASURES)
def test_fluid_measures_match_jax(run, name):
    jm, tm, jf, tf = run
    port, ref = _pair(run, name, (pfl, jpfl))
    assert_close(TimeSeries(port)(tf), JTimeSeries(ref)(jf))
    n = tf.size - 1
    assert_close(port(tf.get_state(n), tf.get_control(n), tf.get_prop()),
                 ref(jf.get_state(n), jf.get_control(n), jf.get_prop()))


def test_min_area_matches_jax(run):
    """MinArea reads the fluid's control (its ``area``)."""
    jm, tm = run[0], run[1]
    rng = np.random.default_rng(3)
    control = {k: np.asarray(v) + 0.0 for k, v in jm.fluid.control.sub_items()}
    control["area"] = 0.01 + rng.random(control["area"].size)
    state = {k: np.asarray(v) for k, v in jm.fluid.state0.sub_items()}
    prop = {k: np.asarray(v) for k, v in jm.fluid.prop.sub_items()}
    out = pfl.MinArea(tm.fluid)(state, control, prop)
    assert_close(out, jpfl.MinArea(jm.fluid)(state, control, prop), rtol=0, rel_atol=0)


def test_fieldstats_matches_jax(run):
    jm, tm, jf, tf = run
    port = psl.FieldStats(tm, psl.StressVonMisesField(tm))
    ref = jpsl.FieldStats(jm, jpsl.StressVonMisesField(jm))
    out = port(tf.get_state(2), tf.get_control(2), tf.get_prop())
    assert_close(out, ref(jf.get_state(2), jf.get_control(2), jf.get_prop()))
    assert out["max"] >= out["avg"] >= out["min"]
    series = TimeSeries(port)(tf)
    assert_close(series, JTimeSeries(ref)(jf))
    assert series["max"].shape == (tf.size,)


def test_timeseries_stats_match_jax(run):
    from vf_fem_tpu.postprocess import TimeSeriesStats as JStats

    jm, tm, jf, tf = run
    port, ref = TimeSeriesStats(psl.StrainEnergy(tm)), JStats(jpsl.StrainEnergy(jm))
    for stat in ("mean", "std", "min", "max", "total", "assem"):
        assert_close(getattr(port, stat)(tf), getattr(ref, stat)(jf))
    assert port.max(tf) >= port.min(tf)
    ns = range(3, 9)
    assert_close(TimeSeries(psl.MinGlottalWidthFromSolid(tm))(tf, ns=ns),
                 JTimeSeries(jpsl.MinGlottalWidthFromSolid(jm))(jf, ns=ns))
    assert TimeSeries(psl.StrainEnergy(tm))(tf, ns=range(0)).size == 0


def test_derived_measure_bases(run):
    """A measure derived from another batches like a primitive one; a
    history measure reads the statefile; a measure without ``assem_pure``
    takes the per-state loop."""
    from vf_fem_tpu_torch.postprocess import (BaseDerivedStateMeasure,
                                              BaseStateHistoryMeasure, BaseStateMeasure)

    _, tm, _, tf = run

    class Doubled(BaseDerivedStateMeasure):
        def assem_pure(self, state, control, prop):
            return 2.0 * self.func.assem_pure(state, control, prop)

    base_m = psl.MinGlottalWidthFromSolid(tm)
    derived = Doubled(base_m)
    assert derived.model is tm
    gw = TimeSeries(base_m)(tf)
    np.testing.assert_allclose(TimeSeries(derived)(tf), 2.0 * gw, rtol=1e-12)

    class NumStates(BaseStateHistoryMeasure):
        def assem(self, f):
            return f.size

    assert NumStates(tm)(tf) == tf.size

    class HostOnly(BaseStateMeasure):
        """A measure computed on the host by ``assem`` alone."""

        def assem(self, state, control, prop):
            return float(np.asarray(state["q"])[0])

    q = TimeSeries(HostOnly(tm))(tf)
    np.testing.assert_array_equal(q, tf.get_state_trajectory()["q"][:, 0])


def test_vertex_glottal_width_matches_jax():
    """VertexGlottalWidth at the vocal-fold mesh's 'separation' vertex."""
    jm = make_vf_fsi_model(nx=6, ny=3)
    from port_fixtures import port_vf_model

    tm = port_vf_model(nx=6, ny=3)
    rng = np.random.default_rng(2)
    state = {k: 1e-3 * rng.standard_normal(np.asarray(v).size) for k, v in tm.state0.items()}
    prop = {k: np.asarray(v) for k, v in jm.prop.sub_items()}
    ref = jpsl.VertexGlottalWidth(jm)
    port = psl.VertexGlottalWidth(tm)
    assert port.vertex == ref.vertex
    control = {k: np.asarray(v) for k, v in tm.control.items()}
    assert_close(port(state, control, prop), ref(state, control, prop))
