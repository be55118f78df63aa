"""
End-to-end phonation on the port (``tests/test_phonation.py``'s
configuration: KelvinVoigt + BernoulliAreaRatioSep on
``vocal_fold_mesh(16, 8)``, emod 3e4, eta 2, psub 8000 Ba, 600 steps at dt
5e-5, the default adaptive Newton) on the CPU in f64, against the JAX
package's run of it (``tests/data/golden_phonation_small.npz``, written by
``tests/make_golden_phonation.py --small``):

- the fold self-oscillates: f0 of the minimum glottal width's steady two
  thirds (``TimeSeries(MinGlottalWidthFromSolid)``,
  ``misc.signal.fundamental_mode_from_rfft``) within one rfft bin of the
  JAX run's, in the physiological range, with an amplitude over 1e-4 cm;
- the width over the first 200 steps within 1e-10 of its largest value
  (the port reads 3.5e-14 of it there and 9.7e-14 over all 600 steps), and
  the Newton counts equal step by step.

About 45 s on an 8-core CPU.
"""

import os

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import forward
from vf_fem_tpu_torch.misc.signal import fundamental_mode_from_rfft, is_oscillating
from vf_fem_tpu_torch.postprocess import TimeSeries
from vf_fem_tpu_torch.postprocess.solid import MinGlottalWidthFromSolid

from chip_smoke import RunReader
from port_fixtures import port_inputs, port_vf_model

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_phonation_small.npz")
GW_RTOL = 1e-10  # of max|gw|, over the first 200 steps


@pytest.fixture(scope="module")
def run():
    data = np.load(GOLDEN)
    model = port_vf_model(nx=16, ny=8)
    model.prop["emod"][:] = 3e4
    model.prop["eta"][:] = 2.0
    model.set_prop(model.prop)
    model.control["psub"][:] = 8000.0
    model.set_control(model.control)
    dt = float(data["dt"])
    n_steps = len(data["gw"])
    state0, cs, prop = port_inputs(model)
    _, traj, infos = forward.integrate_pure(model, state0, cs, prop,
                                            dt * np.arange(n_steps + 1))
    reader = RunReader(state0, traj, model.control, prop)
    gw = TimeSeries(MinGlottalWidthFromSolid(model))(reader)[1:]
    return data, model, gw, infos, dt


def test_self_oscillation_f0_matches_jax(run):
    data, _, gw, _, dt = run
    assert np.all(np.isfinite(gw))
    f0, amp = fundamental_mode_from_rfft(gw[len(gw) // 3:], dt)
    bin_hz = 1.0 / ((len(gw) - len(gw) // 3) * dt)
    assert abs(f0 - float(data["f0"])) <= bin_hz, (f0, float(data["f0"]))
    assert 30.0 < f0 < 1000.0, f"f0 = {f0} Hz"
    assert amp > 1e-4, f"amplitude {amp} too small: no oscillation"
    assert is_oscillating(gw) == bool(data["oscillating"]) is True


def test_glottal_width_matches_jax(run):
    data, _, gw, infos, _ = run
    ref = data["gw"]
    np.testing.assert_allclose(gw[:200], ref[:200], rtol=0,
                               atol=GW_RTOL * np.abs(ref).max())
    np.testing.assert_array_equal(infos.num_iter.numpy()[:200], data["num_iter"][:200])
