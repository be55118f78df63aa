"""
The 2D half of the JAX package's fixture matrix (``tests/test_matrix.py``)
in the port, in f64 on the CPU, against the JAX package's states in
``tests/data/golden_physics_2d.npz`` (``python tests/make_golden_physics.py
--matrix``; the JAX package's matrix takes 10-18 s a configuration, so it
is not run live).  The cases are ``tests/physics_cases.py``'s:

- ``test_solid_transient_step``: each of the ten solid residuals, one
  step on the unit square;
- ``test_fsi_matrix``: KelvinVoigt and Rayleigh with each of three
  psub-driven fluids, three coupled steps;
- ``test_e2e_residual_matrix[2d]``: four solids by four fluids (the
  flow-driven ``BernoulliFlowFixedSep`` among them), two coupled steps.

Each final state is held to the golden entry by entry within 1e-8 of the
field's largest entry (the adaptive Newton solves of the two packages stop
at different last iterates below their tolerance: the port reads 3.1e-11
at most, on ``fsi/KelvinVoigt-BernoulliFixedSep``), with the JAX tests' own assertions: finite,
``abs_err`` < 1e-6 at every step, not diverged, flow through the glottis
and the fold deflecting.

Then the first 17 steps of ``chip_smoke.py``'s M5 physics runs (the two
models of ``PHYSICS_M5`` on the headline settings) against the first
entries of their JAX golden, ``tests/data/golden_m5_physics.npz``: every
eighth u and the q of those steps at rtol 1e-8, the Newton counts equal.
"""

import os

import numpy as np
import pytest

import dynamical_cases
import physics_cases as pc
from vf_fem_tpu_torch import forward

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(DATA, "golden_physics_2d.npz")
RTOL = 1e-8


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _check_state(golden, cid, fin):
    keys = sorted(k.split("|")[1] for k in golden if k.startswith(cid + "|")
                  and k != cid + "|abs_err")
    assert sorted(fin) == keys
    for k in keys:
        ref = golden[f"{cid}|{k}"]
        assert np.all(np.isfinite(fin[k])), k
        np.testing.assert_allclose(fin[k], ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(),
                                   err_msg=k)


def _run(cid):
    model, kind, times = pc.build(dynamical_cases.port_pkg(), cid)
    if kind == "solid":
        import torch

        s0 = {k: torch.zeros(model.ndof, dtype=model.dtype) for k in ("u", "v", "a")}
        control = {"p1": torch.full((model.nvert,), 1000.0, dtype=model.dtype)}
        prop = {k: torch.as_tensor(v) for k, v in model.prop.items()}
        fin, info = model.solve_state1_pure(s0, control, prop, 1e-4)
        return ({k: v.numpy() for k, v in fin.items()},
                {"all": {"abs_err": np.array([float(info.abs_err)])}, "diverged": False})
    ini = {k: np.zeros_like(v) for k, v in model.state0.items()}
    return forward.integrate(model, None, ini, [model.control], model.prop, times,
                             write=False)


@pytest.mark.parametrize("solid", pc.SOLIDS)
def test_solid_transient_step(golden, solid):
    cid = f"solid/{solid}"
    fin, info = _run(cid)
    _check_state(golden, cid, fin)
    assert info["all"]["abs_err"][0] < 1e-6
    assert float(np.abs(fin["u"]).max()) > 0


@pytest.mark.parametrize("fluid", pc.FSI_FLUIDS)
@pytest.mark.parametrize("solid", pc.FSI_SOLIDS)
def test_fsi_matrix(golden, solid, fluid):
    cid = f"fsi/{solid}-{fluid}"
    fin, info = _run(cid)
    _check_state(golden, cid, fin)
    assert float(fin["q"][0]) > 0


@pytest.mark.parametrize("fluid", pc.E2E_FLUIDS)
@pytest.mark.parametrize("solid", pc.E2E_SOLIDS)
def test_e2e_residual_matrix_2d(golden, solid, fluid):
    cid = f"e2e/{solid}-{fluid}"
    fin, info = _run(cid)
    _check_state(golden, cid, fin)
    assert np.all(np.asarray(info["all"]["abs_err"]) < 1e-6)
    assert not info["diverged"]
    assert float(np.abs(fin["q"]).max()) > 0
    assert float(np.abs(fin["u"]).max()) > 1e-9


@pytest.mark.parametrize("tag", ["swelling", "rayleigh"])
def test_m5_physics_golden_prefix(tag):
    import json

    import torch

    import chip_smoke as cs

    gold = np.load(os.path.join(DATA, "golden_m5_physics.npz"))
    cfg = json.loads(str(gold["config"]))
    assert {k: cfg[k] for k in cs.physics_config()} == json.loads(
        json.dumps(cs.physics_config()))
    built, idx_sep = cs.physics_model(torch, "cpu", "M5_3layers.msh", torch.float64,
                                      *cs.PHYSICS_M5[tag])
    assert idx_sep == cfg[tag]["idx_sep"]
    model, state0, controls, prop = built
    n = 17
    _, traj, infos = forward.integrate_pure(model, state0, controls, prop,
                                            cs.DT * np.arange(n + 1), cs.HEADLINE)
    u = traj["u"].numpy()[::8]
    ref_u = gold[f"{tag}|u"][: len(u)]
    np.testing.assert_allclose(u, ref_u, rtol=RTOL, atol=1e-12 * np.abs(ref_u).max())
    np.testing.assert_allclose(traj["q"].numpy().ravel(), gold[f"{tag}|q"][:n], rtol=RTOL)
    np.testing.assert_array_equal(infos.num_iter.numpy(), gold[f"{tag}|num_iter"][:n])
