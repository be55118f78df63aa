"""
The port's static solvers (``vf_fem_tpu_torch.static``,
``SolidModel.solve_static_u1``) and its fixed-point loop
(``solvers.newton.iterative_solve``) on the CPU in f64:

- ``static_solid_configuration`` on the uniaxial model of
  ``tests/test_analytic.py:32-55`` (unit square, nu = 0, pressure on the
  top edge): the closed form within 1e-8 p/E
  (``tests/test_analytic.py:121-140``), and the JAX package's u within
  rtol 1e-9;
- ``static_coupled_configuration_picard``, dense and block-Thomas, on an
  RCM-ordered vocal-fold mesh (KelvinVoigt + BernoulliSmoothMinSep, 10 x
  5, psub 500 Ba): the JAX package's u, q and p within rtol 1e-9, with
  equal iteration counts;
- ``static_coupled_configuration_newton`` on the implicit model: the JAX
  package's state within rtol 1e-9;
- ``solve_static_u1``'s backward (the transposed static solve, K6T's
  plain version on 'btd') against ``jax.vjp`` of the JAX package's, rtol
  1e-8, dense and btd; 'btd' on a mesh that is not bandwidth-ordered
  warns, as in the JAX package;
- ``iterative_solve``: a contraction to its known fixed point, the
  stagnation stop, Aitken's first factor, its clip and its formula, and
  the last iterate returned.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import static as jstatic
from vf_fem_tpu_torch import static
from vf_fem_tpu_torch.load import load_solid_model
from vf_fem_tpu_torch.mesh import unit_square_mesh
from vf_fem_tpu_torch.residuals import solid as slr
from vf_fem_tpu_torch.solvers.newton import iterative_solve, tree_norm

from port_fixtures import MESHES, jax_vf_model, port_vf_model
from test_analytic import EMOD, _uniaxial_model

PSUB = 500.0
P_OVER_E = 1e-8


def _port_uniaxial(nx, ny, jprop):
    """The port's counterpart of test_analytic._uniaxial_model."""
    mesh = unit_square_mesh(nx, ny)
    eps = 1e-12
    mesh.mark_entities(1, lambda m, v: np.all(v[..., 1] < eps, axis=-1), 1,
                       name="fixed", boundary_only=True)
    mesh.mark_entities(1, lambda m, v: np.all(v[..., 1] > 1 - eps, axis=-1), 2,
                       name="pressure", boundary_only=True)
    model = load_solid_model(mesh, slr.KelvinVoigt, device="cpu", dtype=torch.float64)
    return mesh, model, {k: np.asarray(v) for k, v in jprop.sub_items()}


def test_uniaxial_static_closed_form_and_jax():
    opts = {"absolute_tolerance": 1e-16, "relative_tolerance": 1e-14}
    _, jmodel = _uniaxial_model(6, 7)
    jc = jmodel.control.copy()
    jc["p"][:] = P_OVER_E * EMOD
    js, _ = jstatic.static_solid_configuration(jmodel, jc, jmodel.prop, options=opts)
    mesh, model, prop = _port_uniaxial(6, 7, jmodel.prop)
    state, info = static.static_solid_configuration(
        model, {"p1": np.full(model.nvert, P_OVER_E * EMOD)}, prop, opts)
    assert list(state) == ["u", "v", "a"] and not state["v"].any()
    u = state["u"].reshape(-1, 2)
    u_exact = np.zeros_like(u)
    u_exact[:, 1] = -P_OVER_E * mesh.coords[:, 1]
    assert np.abs(u - u_exact).max() < 1e-8 * P_OVER_E
    assert info["abs_err"] < 1e-12 and set(info) == {"num_iter", "abs_err", "rel_err"}
    np.testing.assert_allclose(state["u"], np.asarray(js["u"]), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(js["u"])).max())


@pytest.fixture(scope="module")
def coupled():
    """The RCM-ordered smooth-fluid model in both packages, psub 500 Ba."""
    jm = jax_vf_model("KelvinVoigt", 10, 5, reorder="rcm", fluid="BernoulliSmoothMinSep")
    tm = port_vf_model("KelvinVoigt", 10, 5, reorder="rcm", fluid="BernoulliSmoothMinSep")
    jm.control["psub"][:] = PSUB
    tm.control["psub"][:] = PSUB
    return jm, tm


@pytest.mark.parametrize("solver", ["dense", "btd"])
def test_coupled_picard_matches_jax(solver, coupled):
    jm, tm = coupled
    opts = {"linear_solver": solver}
    js, ji = jstatic.static_coupled_configuration_picard(jm, jm.control, jm.prop, opts)
    ts, ti = static.static_coupled_configuration_picard(tm, tm.control, tm.prop, opts)
    assert ti["num_iter"] == ji["num_iter"] and ti["num_iter"] > 2
    assert list(ts) == ["u", "v", "a", "q", "p"]
    for k in ("u", "q", "p"):
        ref = np.asarray(js[k])
        np.testing.assert_allclose(ts[k], ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max(),
                                   err_msg=k)


def test_coupled_newton_matches_jax():
    jm = jax_vf_model("KelvinVoigt", 8, 4, fluid="BernoulliSmoothMinSep",
                      coupling="implicit")
    tm = port_vf_model("KelvinVoigt", 8, 4, fluid="BernoulliSmoothMinSep",
                       coupling="implicit")
    js, ji = jstatic.static_coupled_configuration_newton(jm, jm.control, jm.prop)
    ts, ti = static.static_coupled_configuration_newton(tm, tm.control, tm.prop)
    assert ti["num_iter"] == ji["num_iter"]
    for k in ("u", "v", "a", "q", "p"):
        ref = np.asarray(js[k])
        np.testing.assert_allclose(ts[k], ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max(),
                                   err_msg=k)


@pytest.mark.parametrize("solver", ["dense", "btd"])
def test_solve_static_u1_vjp_matches_jax(solver, coupled):
    jm, tm = coupled
    js, ts = jm.solid, tm.solid
    rng = np.random.default_rng(5)
    p1 = rng.uniform(0.0, PSUB, ts.nvert)
    u_bar = rng.standard_normal(ts.ndof)
    prop = {k: np.asarray(jm.prop[k]) for k in jm._solid_prop_keys}
    params = (("linear_solver", solver),)

    @jax.jit
    def run(c, p):
        return js.solve_static_u1(jnp.zeros(ts.ndof), c, p, params)[0]

    ju, vjp = jax.vjp(run, {"p1": jnp.asarray(p1)}, {k: jnp.asarray(v) for k, v in prop.items()})
    jc_bar, jp_bar = vjp(jnp.asarray(u_bar))

    c = {"p1": torch.tensor(p1, requires_grad=True)}
    p = {k: torch.tensor(v, requires_grad=True) for k, v in prop.items()}
    u1, _ = ts.solve_static_u1(torch.zeros(ts.ndof, dtype=torch.float64), c, p,
                               {"linear_solver": solver})
    np.testing.assert_allclose(u1.detach().numpy(), np.asarray(ju), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(ju)).max())
    keys = list(p)
    grads = torch.autograd.grad(u1, [c["p1"], *p.values()], torch.as_tensor(u_bar),
                                allow_unused=True)
    refs = [jc_bar["p1"], *(jp_bar[k] for k in keys)]
    for k, ref, g in zip(["p1", *keys], refs, grads):
        ref = np.asarray(ref)
        g = np.zeros_like(ref) if g is None else g.numpy()
        assert np.abs(g - ref).max() <= 1e-8 * np.abs(ref).max(), k


def test_static_btd_warns_on_an_unordered_mesh():
    """As in the JAX package, the block-banded plan of a mesh that is not
    bandwidth-ordered (M5-3layers as meshed) warns that its band
    degenerates toward dense and names the RCM renumbering; the static
    btd solve still agrees with the dense one."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.residuals import fluid as flr

    tm = load_fsi_model(os.path.join(MESHES, "M5_3layers.msh"), slr.KelvinVoigt,
                        flr.BernoulliSmoothMinSep, device="cpu")
    s = tm.solid
    prop = {k: torch.as_tensor(tm.prop[k]) for k in s.prop}
    p1 = torch.full((s.nvert,), PSUB, dtype=torch.float64)
    with pytest.warns(RuntimeWarning, match="RCM"):
        u1, info = s.solve_static_u1(torch.zeros(s.ndof, dtype=torch.float64),
                                     {"p1": p1}, prop, {"linear_solver": "btd"})
    u_dense, _ = s.solve_static_u1(torch.zeros(s.ndof, dtype=torch.float64), {"p1": p1},
                                   prop)
    assert int(info.num_iter) > 0
    torch.testing.assert_close(u1, u_dense, rtol=0.0, atol=1e-9 * float(u_dense.abs().max()))


# -- iterative_solve -------------------------------------------------------------

def _affine(c, b):
    """x <- c x + b on {'x': ...}, with its residual x - (c x + b)."""
    def step(x):
        return {"x": c * x["x"] + b}

    def res(x):
        return {"x": x["x"] - step(x)["x"]}

    return step, res


def test_iterative_solve_contraction_and_last_iterate():
    b = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    step, res = _affine(0.5, b)
    x0 = {"x": torch.zeros(3, dtype=torch.float64)}
    x, info = iterative_solve(x0, res, step)
    # stopped below abs_tol 1e-8 in the residual (1 - c)(x - x*)
    torch.testing.assert_close(x["x"], 2.0 * b, rtol=0.0, atol=2e-8)
    k = int(info.num_iter)
    # the last iterate, not the best: k plain steps from x0
    last = x0
    for _ in range(k):
        last = step(last)
    assert torch.equal(x["x"], last["x"])
    assert float(info.abs_err) < 1e-8 and float(info.abs_err) == float(tree_norm(res(x)))
    # the norm sums the leaves in sorted-key order
    t = {"v": torch.ones(2), "a": torch.full((1,), 2.0)}
    assert float(tree_norm(t)) == float(torch.sqrt(torch.tensor(4.0) + 2.0))


def test_iterative_solve_stagnation_stop():
    """With c = 0.99 each iteration shrinks the residual by 0.99: the first
    one fails the default stagnation ratio 0.98 and stops the loop; under
    a ratio of 0.995 it runs to maximum_iterations."""
    step, res = _affine(0.99, torch.ones(2, dtype=torch.float64))
    x0 = {"x": torch.zeros(2, dtype=torch.float64)}
    _, info = iterative_solve(x0, res, step)
    assert int(info.num_iter) == 1
    _, info = iterative_solve(x0, res, step, {"stagnation_ratio": 0.995,
                                              "maximum_iterations": 7})
    assert int(info.num_iter) == 7


def test_iterative_solve_aitken():
    """Aitken on a linear map: the first factor is aitken_omega0, the next
    w = -w0 <d0, d1 - d0> / |d1 - d0|^2 (the exact secant factor of a
    scalar linear map, 1 / (1 - c), clipped to 2 for c = 0.9), so x after
    two iterations is known in closed form."""
    c, b = 0.9, torch.tensor([1.0], dtype=torch.float64)
    step, res = _affine(c, b)
    x0 = {"x": torch.zeros(1, dtype=torch.float64)}
    params = {"aitken": True, "aitken_omega0": 0.5, "maximum_iterations": 2}
    x, info = iterative_solve(x0, res, step, params)
    x1 = 0.5 * 1.0  # w0 d0, d0 = b
    d0, d1 = 1.0, (c * x1 + 1.0) - x1
    w = -0.5 * d0 * (d1 - d0) / (d1 - d0) ** 2
    assert w > 2.0
    assert float(x["x"]) == pytest.approx(x1 + 2.0 * d1, rel=1e-15)
    # omega0 is clipped too
    x, _ = iterative_solve(x0, res, step, {"aitken": True, "aitken_omega0": 5.0,
                                           "maximum_iterations": 1})
    assert float(x["x"]) == pytest.approx(2.0, rel=1e-15)
    # and Aitken reaches the fixed point of a contraction faster than plain
    step, res = _affine(0.5, b)
    xa, ia = iterative_solve(x0, res, step, {"aitken": True})
    xp, ip = iterative_solve(x0, res, step)
    torch.testing.assert_close(xa["x"], xp["x"], rtol=0.0, atol=4e-8)
    assert int(ia.num_iter) < int(ip.num_iter)
