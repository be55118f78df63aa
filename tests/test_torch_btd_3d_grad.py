"""
Gradients through block-Thomas solves on the extruded 3D fold, on the CPU
in f64: the small extruded stack of ``tests/cases_3d.py`` (``btd3d``,
M5_CB_GA3 at h 0.1 through 3 z-planes, RCM-ordered, 477 dofs), 8 steps of
5e-5 s from rest, banded assembly (K1/K2 at nv = 4 through each other's
VJP, plain versions here), ``linear_solver='btd'`` refreshed every 4
steps, ``1e4 sum(u_final^2)``, value+grad by ``adjoint.integrate_grad``
at the gates of ``tests/test_bsb.py:399-480``: the refined stale adjoint
against the exact one (factors built at u1, K6T's plain version) at rtol
1e-6, bf16-stored factors against the exact one at 1e-5, the stale
gradient's sum over ``emod`` against central differences at 1e-5, and the
dense solver's stale adjoint against the exact one at 1e-6.  The 2D test
holds each ``emod`` entry to its own rtol; here the gradient's entries span
five decades (3e-13 to 3e-8), and the refinement stops at 1e-8 of the
whole residual, so each rtol bounds the error relative to the largest
entry (measured: 8.6e-9 for the stale and dense adjoints, 1.5e-9 for
bf16; the smallest entries err by 1.2e-4 of themselves).  The stale
gradient is held to the JAX package's (``tests/data/golden_grad.npz``,
``python tests/make_golden_grad.py --only 3d``) within 1e-6 of each
property's largest entry.
"""

import os

import numpy as np
import pytest
import torch

import cases_3d
import dynamical_cases
from vf_fem_tpu_torch import adjoint, forward

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_grad.npz")
# tests/make_golden_grad.py's G3D_TIMES and G3D
TIMES = 5e-5 * np.arange(9)
BTD = {"assembly": "banded", "linear_solver": "btd", "jacobian_refresh_steps": 4}
RUNS = {
    "stale": BTD,
    "exact": {**BTD, "adjoint_refine": "exact"},
    "bf16": {**BTD, "btd_store_dtype": "bfloat16"},
    "dense": {**BTD, "linear_solver": "dense"},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small tensor ops a step: one thread (see
    ``tests/test_torch_ddstep.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss(traj, controls, prop, times):
    return torch.sum(traj["u"][-1] ** 2) * 1e4


@pytest.fixture(scope="module")
def runs():
    model, _, _ = cases_3d.build(dynamical_cases.port_pkg(), "btd3d")
    assert model.solid.residual.banded_ok() and model.solid.bsb_plan()[0].ndof == 477
    s0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    out = {name: adjoint.integrate_grad(model, _loss, s0, [model.control], model.prop,
                                        TIMES, params)
           for name, params in RUNS.items()}
    return model, s0, out


def _emod(runs, name):
    return runs[2][name][1]["prop"]["emod"]


@pytest.mark.parametrize("name, rtol", [("stale", 1e-6), ("bf16", 1e-5), ("dense", 1e-6)])
def test_3d_grad_matches_exact(runs, name, rtol):
    """The refined adjoint with carried factors (f64 and bf16 block-Thomas,
    dense) against the exact transposed btd solve at u1: ``emod`` within
    ``rtol`` of its largest entry, and the values of the f64 runs (whose
    Newton solves converge to the same rounding) at rtol 1e-12."""
    if name != "bf16":
        np.testing.assert_allclose(runs[2][name][0], runs[2]["exact"][0], rtol=1e-12)
    g, ref = _emod(runs, name), _emod(runs, "exact")
    assert np.abs(g - ref).max() <= rtol * np.abs(ref).max()


def test_3d_grad_matches_fd(runs):
    """The stale gradient summed over ``emod`` against central differences
    of the run (h = 10 Pa): rtol 1e-5."""
    model, s0, _ = runs
    cs = {k: v[None] for k, v in model.control.items()}
    vals = []
    for h in (10.0, -10.0):
        prop = {k: np.array(v) for k, v in model.prop.items()}
        prop["emod"] = prop["emod"] + h
        fin, _, _ = forward.integrate_pure(model, s0, cs, prop, TIMES, BTD)
        vals.append(float(_loss({"u": fin["u"][None]}, None, None, None)))
    fd = (vals[0] - vals[1]) / 20.0
    np.testing.assert_allclose(float(np.sum(_emod(runs, "stale"))), fd, rtol=1e-5)


def test_3d_grad_matches_jax(runs):
    """The stale gradient within 1e-6 of each property's largest entry of
    the JAX package's, and the value at rtol 1e-12 (a key whose JAX
    gradient is below 1e-12 |value| is a vanishing derivative's rounding,
    and the port's must be below that too)."""
    golden = np.load(GOLDEN)
    value, g = runs[2]["stale"]
    ref_value = float(golden["3d_value"])
    np.testing.assert_allclose(value, ref_value, rtol=1e-12)
    for k, p in g["prop"].items():
        ref = golden[f"3d_grad_{k}"]
        scale, floor = np.abs(ref).max(), 1e-12 * abs(ref_value)
        if scale <= floor:
            assert np.abs(p).max() <= floor, k
            continue
        assert np.abs(p - ref).max() <= 1e-6 * scale, f"{k}: {np.abs(p - ref).max():.3e}"
