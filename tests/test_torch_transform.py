"""
The port's parameter transforms (``vf_fem_tpu_torch.parameters``) against
the JAX package's on the CPU in f64, fed the same seeded numpy vectors
(``convert.from_blocks`` / ``to_blocks`` carry the JAX BlockVectors):

- ``Identity``, ``Scale``, ``ConstantSubset``, ``ExtractSubset``,
  ``LayerModuli`` (on the M5_3layers CAD mesh) and a composition: apply,
  jvp and vjp within rtol 1e-10;
- ``FemResidual.assemble_jac_dense`` against the JAX package's;
- ``TractionShape``'s choice of solve path by the model's device;
- ``TractionShape`` dense (``vocal_fold_mesh(8, 4)``) within rtol 1e-10
  and banded (RCM ``vocal_fold_mesh(10, 5)``: bsb fill, f64 block-Thomas
  factors, the banded traction residual) within rtol 1e-9, banded against
  dense, its solve certificate ``K umesh = T t`` by K4's plain version,
  linearity of the jvp and vjp duality;
- the composed shape gradient of ``tests/test_functional.py:390-440``
  (KelvinVoigtWShape + BernoulliSmoothMinSep at nx=6, ny=3: ``integrate_grad``
  with respect to ``umesh``, then ``TractionShape.apply_vjp``) against the
  JAX package's within rtol 1e-7, and against central differences.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu.load import load_solid_model as jload_solid
from vf_fem_tpu.mesh import vocal_fold_mesh as jvf_mesh
from vf_fem_tpu.mesh.reorder import rcm_mesh as jrcm
from vf_fem_tpu.parameters import transform as jtf
from vf_fem_tpu.residuals import fluid as jflr, solid as jslr
from vf_fem_tpu_torch import adjoint, forward, ops
from vf_fem_tpu_torch.convert import from_blocks, to_blocks
from vf_fem_tpu_torch.load import load_fsi_model, load_solid_model
from vf_fem_tpu_torch.mesh import vocal_fold_mesh
from vf_fem_tpu_torch.parameters import transform as tf
from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

from fixture_models import make_vf_fsi_model
from port_fixtures import MESHES


def _rand(proto: dict, rng, scale=1.0) -> dict:
    return {k: scale * rng.standard_normal(np.shape(v)) for k, v in proto.items()}


def _close(port: dict, ref, rtol, keys=None):
    """Each key of the port's vector within ``rtol`` of the largest entry
    of the reference's (a JAX BlockVector or a dict; exact zeros where the
    reference block is zero)."""
    ref = ref if isinstance(ref, dict) else from_blocks(ref)
    for k in keys or ref:
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=rtol * scale,
                                   err_msg=k)


def _dot(a: dict, b: dict) -> float:
    return float(sum(np.dot(np.ravel(a[k]), np.ravel(b[k])) for k in a))


@pytest.fixture(scope="module")
def m5_models():
    path = os.path.join(MESHES, "M5_3layers.msh")
    jm = jload_solid(path, jslr.KelvinVoigt)
    tm = load_solid_model(path, slr.KelvinVoigt, device="cpu")
    rng = np.random.default_rng(3)
    for k in tm.prop:  # the same (random) properties in both
        v = 1.0 + rng.random(np.shape(tm.prop[k]))
        tm.prop[k][:] = v
        jm.prop[k][:] = v
    return jm, tm


def _pair(name, jm, tm):
    if name == "identity":
        return jtf.Identity(jm), tf.Identity(tm)
    if name == "scale":
        s = {"emod": 2.0, "eta": 0.5}
        return jtf.Scale(jm, s), tf.Scale(tm, s)
    if name == "constant_subset":
        c = {"nu": 0.3, "rho": 1.5}
        return jtf.ConstantSubset(jm, c), tf.ConstantSubset(tm, c)
    if name == "extract_subset":
        return jtf.ExtractSubset(jm, ["emod", "eta"]), tf.ExtractSubset(tm, ["emod", "eta"])
    if name == "layer_moduli":
        return jtf.LayerModuli(jm), tf.LayerModuli(tm)
    # LayerModuli then Scale
    s = {"emod": 3.0}
    return (jtf.LayerModuli(jm) * jtf.Scale(jm, s), tf.LayerModuli(tm) * tf.Scale(tm, s))


@pytest.mark.parametrize("name", ["identity", "scale", "constant_subset",
                                  "extract_subset", "layer_moduli", "composition"])
def test_transform_matches_jax(m5_models, name):
    """apply, apply_jvp and apply_vjp on the same seeded vectors, within
    rtol 1e-10 of the JAX transform's; and the port's own duality."""
    jm, tm = m5_models
    jt, tt = _pair(name, jm, tm)
    assert list(tt.x) == list(from_blocks(jt.x)) and list(tt.y) == list(from_blocks(jt.y))
    rng = np.random.default_rng(11)
    x, dx, hy = _rand(tt.x, rng, 1e3), _rand(tt.x, rng), _rand(tt.y, rng)
    _close(tt.apply(x), jt.apply(to_blocks(x, jt.x)), 1e-10)
    dy = tt.apply_jvp(x, dx)
    _close(dy, jt.apply_jvp(to_blocks(x, jt.x), to_blocks(dx, jt.x)), 1e-10)
    hx = tt.apply_vjp(x, hy)
    _close(hx, jt.apply_vjp(to_blocks(x, jt.x), to_blocks(hy, jt.y)), 1e-10)
    np.testing.assert_allclose(_dot(hy, dy), _dot(hx, dx), rtol=1e-10)


def test_layer_moduli_on_the_cad_layers(m5_models):
    """The port's LayerModuli puts each layer's value on its cells (the
    JAX package's ``test_layer_moduli_on_m5_3layer_cad``)."""
    _, tm = m5_models
    t = tf.LayerModuli(tm)
    assert {"body", "ligament", "cover"} <= set(t.x)
    vals = {"body": 6e4, "ligament": 2e4, "cover": 1e4}
    emod = t.apply({k: np.array([vals.get(k, 0.0)]) for k in t.x})["emod"]
    mesh = tm.residual.mesh()
    for name, val in vals.items():
        cells = mesh.mesh_functions[2] == mesh.subdomains[2][name]
        np.testing.assert_allclose(emod[cells], val)


@pytest.fixture(scope="module")
def shape_solids():
    jmesh = jvf_mesh(8, 4)
    return (jload_solid(jmesh, jslr.KelvinVoigtWShape),
            load_solid_model(vocal_fold_mesh(8, 4), slr.KelvinVoigtWShape, device="cpu"))


@pytest.mark.parametrize("wrt", ["state/u1", "control/tcontact", "prop/umesh",
                                 "prop/emod", "prop/nu"])
def test_assemble_jac_dense_matches_jax(shape_solids, wrt):
    """``FemResidual.assemble_jac_dense`` of the KelvinVoigtWShape residual
    at seeded random fields, with respect to a vector, a DG0, a constant
    and the shape field, within rtol 1e-12 of the JAX package's."""
    jsolid, tsolid = shape_solids
    jr, tr = jsolid.residual, tsolid.residual
    rng = np.random.default_rng(4)
    fields = {}
    for k, v in jr.default_coefficients().items():
        v = np.asarray(v, dtype=float)
        fields[k] = v + (0.01 if k in ("prop/umesh", "state/u1") else 1.0) * rng.random(v.shape)
    fields["prop/ncontact"] = np.array([0.0, 1.0])
    J_j = np.asarray(jr.assemble_jac_dense({k: jnp.asarray(v) for k, v in fields.items()}, wrt))
    J_t = tr.assemble_jac_dense({k: torch.as_tensor(v) for k, v in fields.items()}, wrt)
    assert tuple(J_t.shape) == J_j.shape
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=1e-12, atol=1e-12 * np.abs(J_j).max())


def _traction_checks(t, x, rng, lin_rtol):
    """The port's own checks of a TractionShape: finite nonzero umesh,
    the jvp equal to the difference of applies (it is linear), and vjp
    duality at rtol 1e-9."""
    y = t.apply(x)
    assert np.isfinite(y["umesh"]).all() and np.linalg.norm(y["umesh"]) > 0
    dx = _rand(t.x, rng, 10.0)
    dy = t.apply_jvp(x, dx)
    y2 = t.apply({"tmesh": x["tmesh"] + dx["tmesh"]})
    np.testing.assert_allclose(y2["umesh"] - y["umesh"], dy["umesh"], rtol=lin_rtol,
                               atol=1e-10 * np.abs(y["umesh"]).max())
    hy = _rand(t.y, rng)
    np.testing.assert_allclose(_dot(hy, dy), _dot(t.apply_vjp(x, hy), dx), rtol=1e-9)
    return y, dx, dy, hy


def test_traction_shape_dense_matches_jax(shape_solids):
    jsolid, tsolid = shape_solids
    jt, tt = jtf.TractionShape(jsolid), tf.TractionShape(tsolid)
    assert tt._solver == jt._solver == "dense"
    rng = np.random.default_rng(2)
    x = _rand(tt.x, rng, 1e2)
    y, dx, dy, hy = _traction_checks(tt, x, rng, 1e-8)
    jx = to_blocks(x, jt.x)
    _close(y, jt.apply(jx), 1e-10, ["umesh"])
    _close(dy, jt.apply_jvp(jx, to_blocks(dx, jt.x)), 1e-10, ["umesh"])
    _close(tt.apply_vjp(x, hy), jt.apply_vjp(jx, to_blocks(hy, jt.y)), 1e-10)


def test_traction_shape_banded_matches_jax_and_dense():
    """The banded path (on the model's device, here the CPU: bsb fill, f64
    block-Thomas factors, K6/K6T's plain versions, the banded traction
    residual) against the JAX package's banded path and the port's dense
    one, within rtol 1e-9; its certificate ``|K umesh - T t| / |T t|``
    below 1e-10 with K applied by K4's plain version."""
    jsolid = jload_solid(jrcm(jvf_mesh(10, 5)), jslr.KelvinVoigtWShape)
    tsolid = load_solid_model(vocal_fold_mesh(10, 5), slr.KelvinVoigtWShape,
                              device="cpu", reorder="rcm")
    jt = jtf.TractionShape(jsolid, solver="banded")
    tb = tf.TractionShape(tsolid, solver="banded")
    td = tf.TractionShape(tsolid, solver="dense")
    rng = np.random.default_rng(5)
    x = _rand(tb.x, rng, 1e2)
    before = dict(ops.LAUNCHES)
    y, dx, dy, hy = _traction_checks(tb, x, rng, 1e-7)
    assert ops.LAUNCHES == before  # CPU tensors: the plain versions
    jx = to_blocks(x, jt.x)
    _close(y, jt.apply(jx), 1e-9, ["umesh"])
    _close(tb.apply_vjp(x, hy), jt.apply_vjp(jx, to_blocks(hy, jt.y)), 1e-9)
    _close(y, td.apply(x), 1e-9, ["umesh"])
    _close(tb.apply_vjp(x, hy), td.apply_vjp(x, hy), 1e-8)
    # the certificate K umesh = T t
    Tt = tb.T_mv(torch.as_tensor(x["tmesh"]))
    K = tb.assemble_K_blocks()
    r = ops.bsb_matvec(tb._plan, K, torch.as_tensor(y["umesh"])) - Tt
    assert float(r.norm() / Tt.norm()) < 1e-10


@pytest.mark.parametrize("solver, device, ndof, expected", [
    ("auto", "cpu", 960, "dense"),
    ("auto", "cpu", 47508, "banded"),
    ("auto", "cuda", 960, "banded"),
    ("auto", "cuda:0", 47508, "banded"),
    ("banded", "cpu", 960, "banded"),
    ("dense", "cpu", 47508, "dense"),
    ("banded", "cuda", 960, "banded"),
    ("dense", "cuda", 960, ValueError),
    ("lu", "cpu", 960, ValueError),
])
def test_traction_shape_solver_choice(solver, device, ndof, expected):
    """'auto' takes the dense host path only for a model on the CPU (up to
    ``dense_max_dofs``); a model on the card always solves there (banded),
    and asking it for the dense path raises."""
    if expected is ValueError:
        with pytest.raises(ValueError):
            tf._pick_solver(solver, device, ndof, 6000)
    else:
        assert tf._pick_solver(solver, device, ndof, 6000) == expected


def _shape_models():
    jm = make_vf_fsi_model(SolidResidual=jslr.KelvinVoigtWShape,
                           FluidResidual=jflr.BernoulliSmoothMinSep, nx=6, ny=3)
    tm = load_fsi_model(vocal_fold_mesh(6, 3), slr.KelvinVoigtWShape,
                        flr.BernoulliSmoothMinSep, device="cpu")
    for k in tm.prop:
        tm.prop[k][:] = np.asarray(jm.prop[k])
    for k in tm.control:
        tm.control[k][:] = np.asarray(jm.control[k])
    return jm, tm


def test_shape_gradient_matches_jax():
    """``tests/test_functional.py:390-440`` in both packages: d loss / d
    tmesh = TractionShape.apply_vjp of the adjoint's umesh cotangent, with
    loss = sum(u_final^2) 1e4 + sum(q^2) 1e-6 over 5 steps at dt = 2e-5;
    the umesh gradient and the traction gradient within rtol 1e-7 of the
    JAX package's largest entry, and the port's against a central
    difference along a seeded traction direction (rtol 2e-5)."""
    jm, tm = _shape_models()
    times = 2e-5 * np.arange(6)
    js = jtf.TractionShape(jm.solid)
    ts = tf.TractionShape(tm.solid)
    rng = np.random.default_rng(11)
    x = {"tmesh": 30.0 * rng.standard_normal(ts.x["tmesh"].size)}

    state0 = {k: np.zeros_like(np.asarray(v)) for k, v in jm.state0.sub_items()}
    cs = jforward._stack_controls(jm, [jm.control])
    prop0 = jm.prop_to_dict(jm.prop)

    def jloss(umesh):
        prop = {**prop0, "umesh": umesh}
        fin, traj, _ = jforward.integrate_pure(jm, state0, cs, prop, times, use_remat=True)
        return jnp.sum(fin["u"] ** 2) * 1e4 + 1e-6 * jnp.sum(traj["q"] ** 2)

    umesh_j = np.asarray(from_blocks(js.apply(to_blocks(x, js.x)))["umesh"])
    vj, gj_umesh = jax.value_and_grad(jloss)(jnp.asarray(umesh_j))
    hy_j = js.y
    hy_j[:] = 0.0
    hy_j["umesh"] = np.asarray(gj_umesh)
    gj_t = from_blocks(js.apply_vjp(to_blocks(x, js.x), hy_j))["tmesh"]

    def loss(traj, controls, prop, times_):
        return torch.sum(traj["u"][-1] ** 2) * 1e4 + 1e-6 * torch.sum(traj["q"] ** 2)

    ts0 = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    prop = {**tm.prop, "umesh": ts.apply(x)["umesh"]}
    np.testing.assert_allclose(prop["umesh"], umesh_j, rtol=1e-10,
                               atol=1e-10 * np.abs(umesh_j).max())
    vt, g = adjoint.integrate_grad(tm, loss, ts0, [tm.control], prop, times)
    g_umesh = g["prop"]["umesh"]
    gt_t = ts.apply_vjp(x, {**ts.y, "umesh": g_umesh})["tmesh"]
    assert abs(vt - float(vj)) <= 1e-10 * abs(float(vj))
    for mine, ref in ((g_umesh, np.asarray(gj_umesh)), (gt_t, gj_t)):
        assert np.abs(mine - ref).max() <= 1e-7 * np.abs(ref).max()

    def value(tvec):
        p = {**tm.prop, "umesh": ts.apply({"tmesh": tvec})["umesh"]}
        _, traj, _ = forward.integrate_pure(tm, ts0, {k: v[None] for k, v in tm.control.items()},
                                            p, times)
        return float(loss(traj, None, None, None))

    d = rng.standard_normal(gt_t.size)
    d /= np.linalg.norm(d)
    h = 1e-2
    fd = (value(x["tmesh"] + h * d) - value(x["tmesh"] - h * d)) / (2 * h)
    np.testing.assert_allclose(float(gt_t @ d), fd, rtol=2e-5)
