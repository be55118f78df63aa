"""
The JAX package's extruded-3D FSI tests on the port, in f64 on the CPU,
against the JAX package's runs in ``tests/data/golden_3d.npz`` (``python
tests/make_golden_3d.py``; the JAX tests take 12-50 s each, so they are not
run live).  The cases are ``tests/cases_3d.py``'s:

- ``tests/test_fsi_3d.py``: the interface on the unit cube's z-planes, the
  cube's coupled steps (one flow channel a plane, all flowing) and the
  extruded M5_CB_GA3 stepped by ``solve_state1``;
- ``tests/test_matrix.py::test_e2e_residual_matrix[...-3d]``: four solids
  by four fluids on the extruded ``vocal_fold_mesh(6, 3)``.

(``tests/test_torch_btd_3d.py`` holds the banded btd stack.)  Each final
state is held to the golden within 1e-8 of the field's largest entry, with
the JAX tests' own assertions: finite, ``abs_err`` < 1e-6 at every step,
not diverged, flow through the glottis and the fold deflecting.
"""

import os

import numpy as np
import pytest

import cases_3d
import dynamical_cases
from vf_fem_tpu_torch import forward

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_3d.npz")
RTOL = 1e-8


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _close(out, ref, what):
    assert np.all(np.isfinite(out)), what
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(), err_msg=what)


def _check_state(golden, cid, fin):
    keys = sorted(k.split("|")[1] for k in golden if k.startswith(cid + "|")
                  and k != cid + "|abs_err")
    assert sorted(fin) == keys
    for k in keys:
        _close(np.asarray(fin[k]), golden[f"{cid}|{k}"], f"{cid} {k}")


def _integrate(model, times):
    ini = {k: np.zeros_like(v) for k, v in model.state0.items()}
    return forward.integrate(model, None, ini, [model.control], model.prop, times, write=False)


def test_interface_3d():
    from vf_fem_tpu_torch.mesh import derive_1d_interface, mark_unit_mesh_fixtures, unit_cube_mesh

    mesh = mark_unit_mesh_fixtures(unit_cube_mesh(3, 3, 2))
    s, sdofs, fdofs = derive_1d_interface(mesh, ("pressure",), np.linspace(0, 1, 3))
    assert s.ndim == 2 and s.shape[0] == 3
    assert np.all(np.diff(s, axis=-1) > 0)
    assert sdofs.size == fdofs.size == s.size


def test_fsi_3d_steps(golden):
    model, _, times = cases_3d.build(dynamical_cases.port_pkg(), "cube")
    assert model.fluid.state0["q"].size == 3  # one channel per z-plane
    fin, info = _integrate(model, times)
    _check_state(golden, "cube", fin)
    assert np.all(np.asarray(info["all"]["abs_err"]) < 1e-6)
    assert np.asarray(fin["q"]).shape == (3,) and np.all(fin["q"] > 0)
    assert float(np.abs(fin["u"]).max()) > 1e-8


def test_extruded_m5_3d_fsi(golden):
    model, _, _ = cases_3d.build(dynamical_cases.port_pkg(), "m5x")
    assert model.fluid.state0["q"].size == 3
    model.dt = cases_3d.M5X["dt"]
    state = {k: np.zeros_like(v) for k, v in model.state0.items()}
    for _ in range(cases_3d.M5X["n_steps"]):
        state, info = model.solve_state1(state)
        model.set_ini_state(state)
    _check_state(golden, "m5x", state)
    assert info["abs_err"] < 1e-6
    assert float(np.abs(state["u"]).max()) > 1e-8 and np.all(state["q"] > 0)


@pytest.mark.parametrize("fluid", cases_3d.E2E_FLUIDS)
@pytest.mark.parametrize("solid", cases_3d.E2E_SOLIDS)
def test_e2e_residual_matrix_3d(golden, solid, fluid):
    cid = f"e2e3d/{solid}-{fluid}"
    model, zs, times = cases_3d.build(dynamical_cases.port_pkg(), cid)
    assert model.fluid.state0["q"].size == len(zs)
    fin, info = _integrate(model, times)
    _check_state(golden, cid, fin)
    assert np.all(np.asarray(info["all"]["abs_err"]) < 1e-6)
    assert not info["diverged"]
    assert float(np.abs(fin["q"]).max()) > 0
    assert float(np.abs(fin["u"]).max()) > 1e-9

