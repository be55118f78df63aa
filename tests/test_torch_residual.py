"""
Residuals and Jacobians of the port against the JAX package on the same
fields, in f64: the solid ``assemble_res`` (banded and plain cell pass),
the dense Newton Jacobian, and the Bernoulli fluid residual.
"""

import os

import jax
import numpy as np
import pytest
import torch

from vf_fem_tpu.load import load_solid_model as jload_solid
from vf_fem_tpu.mesh import load_gmsh as jload_gmsh, vocal_fold_mesh as jvf_mesh
from vf_fem_tpu.residuals import fluid as jflr, solid as jslr
from vf_fem_tpu_torch.convert import to_tensors
from vf_fem_tpu_torch.load import load_solid_model as tload_solid
from vf_fem_tpu_torch.mesh import load_gmsh as tload_gmsh, vocal_fold_mesh as tvf_mesh
from vf_fem_tpu_torch.residuals import fluid as tflr, solid as tslr

from port_fixtures import MESHES

# (solid residual, mesh): the test-suite fixture mesh for both solids, and
# the M5-3layers CAD mesh (4 banded groups) for the headline solid
SOLIDS = [
    ("KelvinVoigt", "vf12x6"),
    ("KelvinVoigtWEpithelium", "vf12x6"),
    ("KelvinVoigtWEpithelium", "M5_3layers"),
]
F64 = torch.float64


def _meshes(name):
    """The same mesh built by each package."""
    if name == "vf12x6":
        return jvf_mesh(12, 6), tvf_mesh(12, 6)
    path = os.path.join(MESHES, name + ".msh")
    return jload_gmsh(path), tload_gmsh(path)


def _random_value(key, shape, rng):
    """Physically plausible random coefficient values."""
    name = key.split("/", 1)[1]
    if key.startswith("state/"):
        return 1e-3 * rng.standard_normal(shape)
    table = {
        "p1": lambda: 1e3 * rng.random(shape),
        "tcontact": lambda: 1e2 * rng.standard_normal(shape),
        "rho": lambda: rng.uniform(0.5, 1.5, shape),
        "emod": lambda: rng.uniform(1e4, 1e5, shape),
        "eta": lambda: rng.uniform(1.0, 5.0, shape),
        "nu": lambda: np.full(shape, 0.45),
        # a third of the membrane cells at emod = 0 (the guarded branch)
        "emod_membrane": lambda: rng.uniform(1e4, 1e5, shape)
        * (rng.random(shape) > 0.33),
        "nu_membrane": lambda: rng.uniform(0.2, 0.45, shape),
        "th_membrane": lambda: rng.uniform(0.0, 0.05, shape),
        "ycontact": lambda: np.full(shape, 0.6),
        "ncontact": lambda: np.array([0.0, 1.0]),
        "kcontact": lambda: np.full(shape, 1e8),
    }
    return table[name]()


@pytest.fixture(scope="module", params=SOLIDS, ids="-".join)
def residual_pair(request):
    solid, mesh = request.param
    jm, tm = _meshes(mesh)
    jR = getattr(jslr, solid)(jm)
    tR = getattr(tslr, solid)(tm, device="cpu", dtype=F64)
    assert list(tR.coefficient_spec) == list(jR.coefficient_spec)
    rng = np.random.default_rng(3)
    fields = {
        k: _random_value(k, jR.coefficient_shape(k), rng)
        for k in jR.coefficient_spec
    }
    return jR, tR, fields


@pytest.mark.parametrize("banded", [True, False], ids=["banded", "plain"])
def test_assemble_res_matches_jax(residual_pair, banded):
    jR, tR, fields = residual_pair
    assert tR.banded_ok()
    ref = np.asarray(jax.jit(jR.assemble_res)(fields))
    out = tR.assemble_res(to_tensors(fields, "cpu", F64), banded=banded)
    np.testing.assert_allclose(
        out.numpy(), ref, rtol=1e-12, atol=1e-15 * np.abs(ref).max()
    )


@pytest.fixture(scope="module", params=SOLIDS, ids="-".join)
def solid_pair(request):
    solid, mesh = request.param
    jmesh, tmesh = _meshes(mesh)
    jm = jload_solid(jmesh, getattr(jslr, solid))
    tm = tload_solid(tmesh, getattr(tslr, solid), device="cpu", dtype=F64)
    return jm, tm


def test_jac_u_dense_matches_jax(solid_pair):
    jm, tm = solid_pair
    rng = np.random.default_rng(4)
    jprop = jm.prop_to_dict(jm.prop)
    assert list(tm.prop) == list(jprop)
    spec = tm.residual.coefficient_spec
    prop = {
        k: _random_value("prop/" + k, v.shape, rng).reshape(v.shape)
        for k, v in jprop.items()
    }
    # contact engaged on part of the surface
    prop["ycontact"] = np.array([0.45])
    assert all("prop/" + k in spec for k in prop)
    state0 = {k: 1e-3 * rng.standard_normal(tm.ndof) for k in ("u", "v", "a")}
    control = {"p1": 1e3 * rng.random(tm.nvert)}
    u1 = 1e-2 * rng.standard_normal(tm.ndof)
    dt = 1e-4
    ref = np.asarray(jax.jit(jm.jac_u_dense, static_argnums=4)(
        u1, state0, control, prop, dt
    ))
    t = lambda d: to_tensors(d, "cpu", F64)
    out = tm.jac_u_dense(torch.from_numpy(u1), t(state0), t(control),
                         t(prop), dt)
    np.testing.assert_allclose(
        out.numpy(), ref, rtol=1e-11, atol=1e-15 * np.abs(ref).max()
    )


def _fluid_inputs(case, n, rng):
    s = np.cumsum(rng.uniform(0.01, 0.05, n)) - 0.01
    area = rng.uniform(0.02, 0.2, n)
    psub, area_lb = 8000.0, 1e-4
    if case == "tied_min":
        # a three-way tie at the minimum, so also in the separation gap
        # |area - r_sep * amin|: both argmin/argmax must take the first
        area[[4, 9, 13]] = area.min() * 0.5
    elif case == "clamped":
        area[6:12] = -1e-3  # closed: clamped at area_lb, all tied
    elif case == "reverse_flow":
        psub = -500.0
    state = {"q": rng.standard_normal(1), "p": rng.standard_normal(n)}
    control = {"area": area, "psub": np.array([psub]), "psup": np.array([0.0])}
    prop = {
        "rho_air": np.array([1.1225e-3]),
        "r_sep": np.array([1.2]),
        "area_lb": np.array([area_lb]),
    }
    return s, state, control, prop


@pytest.mark.parametrize("case", ["random", "tied_min", "clamped", "reverse_flow"])
def test_bernoulli_area_ratio_sep_matches_jax(case):
    rng = np.random.default_rng(5)
    s, state, control, prop = _fluid_inputs(case, 20, rng)
    jr = jflr.BernoulliAreaRatioSep(s)
    tr = tflr.BernoulliAreaRatioSep(s, device="cpu", dtype=F64)
    assert [list(a) for a in tr.res_args] == [list(a) for a in jr.res_args]
    ref = jr.res(state, control, prop)
    t = lambda d: to_tensors(d, "cpu", F64)
    out = tr.res(t(state), t(control), t(prop))
    for k in ("q", "p"):
        np.testing.assert_allclose(
            out[k].numpy(), np.asarray(ref[k]), rtol=1e-13, err_msg=k
        )
