"""
The two fixed-separation Bernoulli fluids (``BernoulliFixedSep``, driven by
``psub``, and ``BernoulliFlowFixedSep``, driven by ``qsub``) against the
JAX package in f64: the residuals on random channels (rtol 1e-13, one and
two stacked channels, separation at either end and inside, closed areas
under the floor, reverse flow), the closed form of
``tests/test_fluid_semantics.py:24``, the loader's ``idx_sep`` from a
'separation' vertex label (``:84``) and its fallback on meshes without one
(the residual's default, 0, in both packages), and the fluids' dynamical
and linearized dynamical models (``tests/test_dynamical.py:168-200``).
"""

import os

import numpy as np
import pytest
import torch

from vf_fem_tpu import load as jload
from vf_fem_tpu import mesh as jmesh
from vf_fem_tpu.residuals import fluid as jflr, solid as jslr
from vf_fem_tpu_torch import load as tload
from vf_fem_tpu_torch import mesh as tmesh
from vf_fem_tpu_torch.convert import to_tensors
from vf_fem_tpu_torch.residuals import fluid as tflr, solid as tslr

from port_fixtures import MESHES

F64 = torch.float64
FLUIDS = ["BernoulliFixedSep", "BernoulliFlowFixedSep"]
t = lambda d: to_tensors(d, "cpu", F64)


def _inputs(fluid, case, shape, rng):
    n = shape[-1]
    s = np.cumsum(rng.uniform(0.01, 0.05, shape), axis=-1) - 0.01
    area = rng.uniform(0.02, 0.2, shape)
    drive = np.full(shape[:-1] or (1,), 8000.0 if fluid == "BernoulliFixedSep" else 75.0)
    if case == "closed":
        area[..., n // 3: n // 2] = -1e-3  # under the floor
    elif case == "reverse":
        drive = -drive
    n_fluid = int(np.prod(shape[:-1])) if shape[:-1] else 1
    state = {"q": rng.standard_normal(n_fluid), "p": rng.standard_normal(area.size)}
    key = "psub" if fluid == "BernoulliFixedSep" else "qsub"
    control = {"area": area.reshape(-1), key: drive.reshape(-1),
               "psup": np.full(n_fluid, 50.0)}
    prop = {"rho_air": np.full(n_fluid, 1.1225e-3)}
    return s, state, control, prop


@pytest.mark.parametrize("shape", [(20,), (2, 20)], ids=["1ch", "2ch"])
@pytest.mark.parametrize("idx_sep", [0, 7, 19])
@pytest.mark.parametrize("case", ["random", "closed", "reverse"])
@pytest.mark.parametrize("fluid", FLUIDS)
def test_residual_matches_jax(fluid, case, idx_sep, shape):
    rng = np.random.default_rng(21)
    s, state, control, prop = _inputs(fluid, case, shape, rng)
    jr = getattr(jflr, fluid)(s, idx_sep=idx_sep)
    tr = getattr(tflr, fluid)(s, idx_sep=idx_sep, device="cpu", dtype=F64)
    assert [list(a) for a in tr.res_args] == [list(a) for a in jr.res_args]
    for a, b in zip(tr.res_args, jr.res_args):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    ref = jr.res(state, control, prop)
    out = tr.res(t(state), t(control), t(prop))
    for k in ("q", "p"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-13,
                                   err_msg=k)


def _triangular_channel(n=21):
    s = np.linspace(0.0, 1.0, n)
    a_min, a_max = 0.1, 1.0
    return s, a_max - (a_max - a_min) * (1 - np.abs(2 * s - 1))


def test_fixed_sep_matches_closed_form():
    """Bernoulli up to the separation index, psup after it
    (``tests/test_fluid_semantics.py:24``)."""
    s, area = _triangular_channel()
    idx_sep = len(s) // 2
    model = tload.load_fluid_model(s, tflr.BernoulliFixedSep, idx_sep=idx_sep,
                                   device="cpu", dtype=F64)
    rho, psub, psup = 1.2e-3, 8000.0, 0.0
    control = t({"area": area, "psub": [psub], "psup": [psup]})
    qp = model.solve_pure(control, t({"rho_air": [rho]}), t(model.state0))
    q, p = float(qp["q"][0]), qp["p"].numpy()
    a_sep = area[idx_sep]
    q_exact = np.sqrt(2 / rho * (psub - psup) / a_sep**-2)
    np.testing.assert_allclose(q, q_exact, rtol=1e-12)
    p_exact = psup + 0.5 * rho * q_exact**2 * (a_sep**-2 - area**-2)
    np.testing.assert_allclose(p[:idx_sep + 1], p_exact[:idx_sep + 1], rtol=1e-10)
    np.testing.assert_allclose(p[idx_sep + 1:], psup, atol=1e-10)
    assert p[0] < psub
    assert np.argmin(p[:idx_sep + 1]) == idx_sep


def test_flow_fixed_sep_matches_closed_form():
    """The flow-driven variant: q is qsub, p Bernoulli's from it."""
    s, area = _triangular_channel()
    idx_sep = len(s) // 2
    model = tload.load_fluid_model(s, tflr.BernoulliFlowFixedSep, idx_sep=idx_sep,
                                   device="cpu", dtype=F64)
    rho, qsub, psup = 1.2e-3, 40.0, 10.0
    control = t({"area": area, "qsub": [qsub], "psup": [psup]})
    qp = model.solve_pure(control, t({"rho_air": [rho]}), t(model.state0))
    assert float(qp["q"][0]) == qsub
    p_exact = psup + 0.5 * rho * qsub**2 * (area[idx_sep]**-2 - area**-2)
    np.testing.assert_allclose(qp["p"].numpy()[:idx_sep + 1], p_exact[:idx_sep + 1],
                               rtol=1e-10)
    np.testing.assert_allclose(qp["p"].numpy()[idx_sep + 1:], psup, atol=1e-10)


def _meshes(name):
    """The same mesh from each package: the unit square and the vocal-fold
    fixture, each with a 'separation' vertex, and the M5 CAD mesh, whose
    labels are 'separation-inf' and 'separation-sup' only."""
    if name == "unit":
        return (jmesh.mark_unit_mesh_fixtures(jmesh.unit_square_mesh(4, 4)),
                tmesh.mark_unit_mesh_fixtures(tmesh.unit_square_mesh(4, 4)))
    if name == "vf":
        return jmesh.vocal_fold_mesh(8, 4), tmesh.vocal_fold_mesh(8, 4)
    path = os.path.join(MESHES, "M5_3layers.msh")
    return jmesh.load_gmsh(path), tmesh.load_gmsh(path)


@pytest.mark.parametrize("mesh", ["unit", "vf", "M5_3layers"])
@pytest.mark.parametrize("fluid", FLUIDS)
def test_loader_idx_sep_parity(fluid, mesh):
    """``load_fsi_model`` derives idx_sep as the JAX package does: the
    interface position of the 'separation' vertex where the mesh has one
    (``tests/test_fluid_semantics.py:84``), else the residual's default 0.
    Both coupled fluids give the same residual on the same inputs, which
    holds the separation mask."""
    jm_, tm_ = _meshes(mesh)
    jm = jload.load_fsi_model(jm_, jslr.KelvinVoigt, getattr(jflr, fluid))
    tm = tload.load_fsi_model(tm_, tslr.KelvinVoigt, getattr(tflr, fluid), device="cpu",
                              dtype=F64)
    sdofs = np.asarray(jm._solid_dofs)
    np.testing.assert_array_equal(tm._solid_dofs.numpy(), sdofs)
    expected = tload.separation_index(tm.solid.residual.mesh(), sdofs)
    try:  # the JAX package's derivation (vf_fem_tpu/load.py:118-131)
        sep = jmesh.locate_separation_vertex(jm_)
        assert expected == int(np.nonzero(sdofs == sep)[0][0])
    except ValueError:
        assert expected is None  # no 'separation' label: idx_sep stays 0
    assert (expected is None) == (mesh == "M5_3layers")
    n = sdofs.size
    rng = np.random.default_rng(22)
    key = list(tm.fluid.control)[1]
    state = {"q": rng.standard_normal(1), "p": rng.standard_normal(n)}
    control = {"area": rng.uniform(0.05, 0.5, n), key: np.array([1000.0]),
               "psup": np.array([0.0])}
    prop = {"rho_air": np.array([1.2e-3])}
    ref = jm.fluid.residual.res(state, control, prop)
    out = tm.fluid.res_pure(t(state), t(control), t(prop))
    for k in ("q", "p"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-13)
    # beyond the separation index the pressure is psup (0)
    p = out["p"].numpy() - state["p"]
    idx = 0 if expected is None else expected
    np.testing.assert_allclose(p[idx + 1:], 0.0, atol=1e-12)


def test_explicit_idx_sep_wins_over_the_label():
    mesh = tmesh.mark_unit_mesh_fixtures(tmesh.unit_square_mesh(4, 4))
    tm = tload.load_fsi_model(mesh, tslr.KelvinVoigt, tflr.BernoulliFixedSep,
                              fluid_kwargs={"idx_sep": 2}, device="cpu", dtype=F64)
    n = tm.fluid.control["area"].size
    control = t({"area": np.full(n, 0.5), "psub": [1000.0], "psup": [0.0]})
    qp = tm.fluid.solve_pure(control, t({"rho_air": [1.2e-3]}), t(tm.fluid.state0))
    np.testing.assert_allclose(qp["p"].numpy()[3:], 0.0, atol=1e-12)
    assert abs(float(qp["p"][2])) == 0.0 and float(qp["q"][0]) > 0


def _dynamical_pair(fluid, model_type):
    s = np.linspace(0, 1, 12)
    kw = {"idx_sep": 6}
    jm = jload.load_fluid_model(s, getattr(jflr, fluid), model_type=model_type, **kw)
    tm = tload.load_fluid_model(s, getattr(tflr, fluid), model_type=model_type,
                                device="cpu", dtype=F64, **kw)
    rng = np.random.default_rng(3)
    key = "psub" if fluid == "BernoulliFixedSep" else "qsub"
    vals = {
        "control": {"area": 0.5 + 0.3 * rng.random(12), key: 8000.0 if key == "psub" else 50.0,
                    "psup": 0.0},
        "prop": {"rho_air": 1.1225e-3},
        "state": {"q": 50.0, "p": 100.0},
    }
    if model_type == "linearized_dynamical":
        vals["dstate"] = {"q": rng.standard_normal(1), "p": rng.standard_normal(12)}
        vals["dcontrol"] = {"area": 1e-2 * rng.standard_normal(12), key: 3.0, "psup": 1.0}
    for name, values in vals.items():
        for m in (jm, tm):
            cur = getattr(m, name)
            if isinstance(cur, dict):
                full = {k: np.array(np.broadcast_to(np.asarray(values[k], dtype=float),
                                                    (v.numel(),))) for k, v in cur.items()}
                getattr(m, "set_" + name)(full)
            else:
                b = cur.copy()
                for k, v in values.items():
                    b[k][:] = v
                getattr(m, "set_" + name)(b)
    return jm, tm


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("model_type", ["dynamical", "linearized_dynamical"])
@pytest.mark.parametrize("fluid", FLUIDS)
def test_dynamical_models_match_jax(fluid, model_type):
    """Residual and Jacobian blocks at rtol 1e-12.  Each block's atol is
    1e-12 times the larger of its own largest entry and the scale of the
    terms it differentiates, max|p or q| over max|column| (a nonzero
    column): a block that
    vanishes analytically (the fixed-separation pressure does not depend
    on rho_air) holds only their rounding."""
    jm, tm = _dynamical_pair(fluid, model_type)
    res_j, res_t = jm.assem_res(), tm.assem_res()
    for k in ("q", "p"):
        np.testing.assert_allclose(_as_np(res_t[k]), np.asarray(res_j[k]), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(res_j[k])).max())
    terms = {k: np.abs(_as_np(tm.state[k])).max() + np.abs(_as_np(res_t[k])).max()
             for k in ("q", "p")}
    cols = {**tm.state, **tm.control, **tm.prop}
    for which in ("dres_dstate", "dres_dstatet", "dres_dcontrol", "dres_dprop"):
        A_j = getattr(jm, "assem_" + which)()
        A_t = getattr(tm, "assem_" + which)()
        for (rk, ck), blk in A_t.items():
            ref = np.asarray(A_j[rk, ck])
            col = np.abs(_as_np(cols[ck])).max()
            scale = max(np.abs(ref).max(), terms[rk] / col if col > 0 else 0.0)
            np.testing.assert_allclose(_as_np(blk), ref, rtol=1e-12, atol=1e-12 * scale,
                                       err_msg=f"{which} {rk},{ck}")
