"""
The M5 FSAI run of the card's smoke (``chip_smoke.py`` phase 12) on the
CPU: the port against ``tests/data/golden_m5_fsai.npz``, the JAX package's
run (``tests/make_golden_fsai.py``: ``meshes/M5_CB_GA3.msh``, KelvinVoigt +
BernoulliAreaRatioSep, a 44-tube tract, the contact plane below the
midline, the M5 headline's solver settings, 100 steps at the tract's dt):

- f64, banded assembly as on the card: u every 10 steps (rtol 1e-8, atol
  1e-12), q at every step and the final p, pinc, pref (rtol 1e-8), Newton
  iterations equal, no lagged step;
- f32: each stored u within 10x the JAX package's own f32-vs-f64
  difference of the JAX f32 run (phase 11's f32 tolerance).
"""

import json
import os

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import forward

from port_fixtures import port_inputs, port_m5_fsai_model

DATA = os.path.join(os.path.dirname(__file__), "data", "golden_m5_fsai.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(DATA)


def _run(golden, dtype):
    config = json.loads(str(golden["config"]))
    tm = port_m5_fsai_model(config, dtype)
    assert tm.check_envelope() and tm.dt == config["dt"]
    params = {**config["params"], "assembly": "banded"}
    return forward.integrate_pure(tm, *port_inputs(tm), golden["times"], params)


def test_m5_fsai_golden_f64(golden):
    fin, traj, infos = _run(golden, torch.float64)
    every = int(golden["steps"][0])
    np.testing.assert_allclose(traj["u"].numpy()[every - 1 :: every], golden["u"],
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(traj["q"].numpy().ravel(), golden["q"], rtol=1e-8)
    for k in ("p", "pinc", "pref"):
        ref = golden[f"{k}_final"]
        np.testing.assert_allclose(fin[k].numpy(), ref, rtol=1e-8,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)
    np.testing.assert_array_equal(infos.num_iter.numpy(), golden["num_iter"])
    assert bool(infos.bracketed.all()) and bool(golden["bracketed"].all())


def test_m5_fsai_f32_against_jax_f32(golden):
    _, traj, infos = _run(golden, torch.float32)
    every = int(golden["steps"][0])
    u = traj["u"].double().numpy()[every - 1 :: every]
    scale = [np.abs(b).max() for b in golden["u"]]
    diff = [float(np.abs(a - b).max() / s) for a, b, s in zip(u, golden["f32_u"], scale)]
    gates = 10 * golden["f32_vs_f64_steps"]
    assert all(d <= g for d, g in zip(diff, gates)), (diff, gates.tolist())
    assert bool(infos.bracketed.all())
