"""
``tests/test_bsb.py::test_btd_banded_3d_trajectory`` on the port, in f64 on
the CPU: the small extruded stack of ``chip_smoke.py`` phase 17
(``tests/cases_3d.py``'s ``btd3d``: M5_CB_GA3 at h 0.1 through 3 z-planes,
RCM-ordered, 477 dofs) run dense with the exact Jacobian and banded with
block-Thomas solves (refresh 6, fixed-3), f64 and bf16 factors.  Each
trajectory is held to the JAX package's (``tests/data/golden_3d.npz``,
``python tests/make_golden_3d.py``) within 1e-8 of the field's largest
entry, and to each other at the JAX test's own gates.
"""

import os

import numpy as np
import torch

import cases_3d
import chip_smoke as cs
import dynamical_cases
from vf_fem_tpu_torch import forward

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_3d.npz")
RTOL = 1e-8


def _close(out, ref, what):
    assert np.all(np.isfinite(out)), what
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(), err_msg=what)


def test_btd_banded_3d_trajectory():
    """Dense exact against banded btd, f64 and bf16 factors
    (tests/test_bsb.py:296-353), each trajectory against the JAX one."""
    golden = np.load(GOLDEN)
    model, _, times = cases_3d.build(dynamical_cases.port_pkg(), "btd3d")
    assert model.solid.residual.banded_ok()
    state0 = {k: torch.zeros(v.size, dtype=torch.float64) for k, v in model.state0.items()}
    controls = {k: torch.as_tensor(v)[None] for k, v in model.control.items()}
    prop = {k: torch.as_tensor(v) for k, v in model.prop.items()}
    u = {}
    for run, params in cs.EXTRUDED_SMALL_RUNS.items():
        _, traj, _ = forward.integrate_pure(model, state0, controls, prop, times, params)
        u[run] = traj["u"].numpy()
        _close(u[run], golden[f"btd3d|{run}|u"], f"{run} u")
        _close(traj["q"].numpy(), golden[f"btd3d|{run}|q"], f"{run} q")
    np.testing.assert_allclose(u["btd"], u["dense"], rtol=1e-7, atol=1e-11)
    scale = np.abs(u["dense"]).max()
    assert np.abs(u["btd16"] - u["dense"]).max() < cs.EXTRUDED_BF16_VS_DENSE * scale
