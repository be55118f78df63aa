"""
The port's gradient path (``vf_fem_tpu_torch.adjoint``) against the JAX
package's ``adjoint`` on the CPU in f64, at small size (8 steps at dt =
2e-5, the functional of ``tests/test_adjoint.py``):

- KelvinVoigt + BernoulliSmoothMinSep (the JAX package's differentiation
  default, nx=8, ny=4), 'dense', adaptive Newton;
- KelvinVoigtWEpithelium + BernoulliAreaRatioSep, 'dense' with refresh
  windows of 4 steps and Newton-Schulz refreshes (the stale-factor IFT
  rule with its refined adjoint);
- the RCM model of ``tests/test_torch_btd.py``, 'btd' with bf16 factors
  and refresh 4, the refined ('stale') and the 'exact' adjoint;

each gradient group held per key to ``max|g_port - g_jax| <= rtol
max|g_jax|`` (rtol 1e-8; 1e-6 for the 'stale' refined btd case), and the
value to the no-grad forward bit for bit.  Then the port's own checks:
finite differences of psub, emod and the last time, the statefile replay
(``adjoint.integrate``) on a file written by the JAX package, K5's
backward (``ops.newmark_step``) by ``gradcheck``, the Taylor test, no
graph and no version error on the gradient path.  The Krylov solvers'
gradients are ``tests/test_torch_krylov_adjoint.py``'s.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import adjoint as jadjoint
from vf_fem_tpu import forward as jforward
from vf_fem_tpu.residuals import fluid as jflr
from vf_fem_tpu_torch import adjoint, forward, ops, step_graph
from vf_fem_tpu_torch.equations import newmark
from vf_fem_tpu_torch.misc.taylor import taylor_convergence

from fixture_models import make_vf_fsi_model
from port_fixtures import jax_vf_model, port_inputs, port_smooth_model, port_vf_model

N_STEPS = 8
DT = 2e-5
TIMES = DT * np.arange(N_STEPS)

# the JAX package's settings of each case, and the port model's constructor
CASES = {
    "smooth-dense": ({}, 1e-8),
    "dense-ns": ({"jacobian_update": "once_per_step", "stagnation_ratio": 0.5,
                  "jacobian_refresh_steps": 4, "jacobian_refresh_mode": "ns",
                  "jacobian_full_refresh_windows": 4}, 1e-8),
    "btd-stale": ({"linear_solver": "btd", "btd_store_dtype": "bfloat16",
                   "jacobian_refresh_steps": 4, "stagnation_ratio": 0.5,
                   "adjoint_refine": "stale"}, 1e-6),
    "btd-exact": ({"linear_solver": "btd", "btd_store_dtype": "bfloat16",
                   "jacobian_refresh_steps": 4, "stagnation_ratio": 0.5,
                   "adjoint_refine": "exact"}, 1e-8),
}


def _jax_functional(traj, controls, prop, times):
    """tests/test_adjoint.py:27-32."""
    return jnp.sum(traj["u"][-1] ** 2) * 1e4 + 1e-8 * jnp.sum(traj["q"] ** 2)


def _functional(traj, controls, prop, times):
    return torch.sum(traj["u"][-1] ** 2) * 1e4 + 1e-8 * torch.sum(traj["q"] ** 2)


@pytest.fixture(scope="module")
def smooth():
    jm = make_vf_fsi_model(FluidResidual=jflr.BernoulliSmoothMinSep, nx=8, ny=4)
    return jm, port_smooth_model(jm)


def _models(case, smooth):
    if case == "smooth-dense":
        return smooth
    if case == "dense-ns":
        return (jax_vf_model("KelvinVoigtWEpithelium", 8, 4),
                port_vf_model("KelvinVoigtWEpithelium", 8, 4))
    return (jax_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm"),
            port_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm"))


def assert_grads_close(gp, gj, rtol, value):
    """Each key of each group within ``rtol`` of its largest JAX entry.  A
    key whose JAX gradient is below 1e-12 |value| is the rounding of an
    analytically zero (or vanishing) derivative, whose digits neither
    package fixes: the port's must be below that too.  Measured: the
    saturated sigmoid's ``zeta_sep`` (2.0e-26 against a value of 0.218 in
    both packages: 1 - sigma below an ulp of sigma) and ``rho_air`` on the
    solid in the statefile replay (9.5e-18 against 1.2e-4: Bernoulli's
    rho q^2 does not depend on rho, so the pressure does not)."""
    for group in ("ini_state", "controls", "prop"):
        gjd = gj[group]
        gjd = dict(gjd.sub_items()) if hasattr(gjd, "sub_items") else gjd
        for k, g in gjd.items():
            g = np.asarray(g)
            p = gp[group][k]
            assert p.shape == g.shape, (group, k)
            scale = np.abs(g).max()
            floor = 1e-12 * abs(value)
            if scale <= floor:
                assert np.abs(p).max() <= floor, (group, k)
                continue
            err = np.abs(p - g).max()
            assert err <= rtol * scale, f"{group}/{k}: {err:.3e} of {scale:.3e}"
    gt, jt = gp["times"], np.asarray(gj["times"])
    assert np.abs(gt - jt).max() <= rtol * np.abs(jt).max()


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_grad_matches_jax(case, smooth):
    jm, tm = _models(case, smooth)
    params, rtol = CASES[case]
    ini = jm.state0.copy()
    ini[:] = 0.0
    vj, gj = jadjoint.integrate_grad(jm, _jax_functional, ini, [jm.control], jm.prop,
                                     TIMES, params)
    s0, cs, prop = port_inputs(tm)
    before = dict(ops.LAUNCHES)
    tm.solid.adjoint_counts.update(solves=0, refine_iterations=0)
    vt, gt = adjoint.integrate_grad(tm, _functional, s0, [tm.control], prop, TIMES, params)
    assert ops.LAUNCHES == before  # CPU tensors: the plain versions
    assert tm.solid.adjoint_counts["solves"] == N_STEPS - 1
    if case == "btd-stale":
        assert tm.solid.adjoint_counts["refine_iterations"] > 0
    assert abs(vt - vj) <= 1e-10 * abs(vj)
    assert_grads_close(gt, gj, rtol, vj)
    # the value is the no-grad forward's bit for bit
    _, traj, _ = forward.integrate_pure(tm, s0, cs, prop, TIMES, params)
    assert float(_functional(traj, None, None, None)) == vt


def _value(model, control, prop, times):
    s0, cs, _ = port_inputs(model)
    cs = {k: v[None] for k, v in control.items()}
    _, traj, _ = forward.integrate_pure(model, s0, cs, prop, times)
    return float(_functional(traj, None, None, None))


@pytest.fixture(scope="module")
def smooth_grad(smooth):
    _, tm = smooth
    s0, _, prop = port_inputs(tm)
    return adjoint.integrate_grad(tm, _functional, s0, [tm.control], prop, TIMES)


def test_grad_matches_fd(smooth, smooth_grad):
    """d/d(psub) against central differences (h = 1 Ba, rtol 1e-5) and
    d/d(emod) along a uniform change (h = 0.1, rtol 1e-4), as
    ``tests/test_adjoint.py:43-78`` holds the JAX package."""
    _, tm = smooth
    value, grads = smooth_grad
    assert np.isfinite(value) and value > 0
    g_psub = grads["controls"]["psub"].sum()
    vals = []
    for h in (1.0, -1.0):
        c = {k: v.copy() for k, v in tm.control.items()}
        c["psub"] = c["psub"] + h
        vals.append(_value(tm, c, tm.prop, TIMES))
    fd = (vals[0] - vals[1]) / 2.0
    assert fd != 0
    np.testing.assert_allclose(g_psub, fd, rtol=1e-5)

    g_emod = grads["prop"]["emod"].sum()
    vals = []
    for h in (0.1, -0.1):
        p = {k: v.copy() for k, v in tm.prop.items()}
        p["emod"] = p["emod"] + h
        vals.append(_value(tm, tm.control, p, TIMES))
    np.testing.assert_allclose(g_emod, (vals[0] - vals[1]) / 0.2, rtol=1e-4)


def test_grad_wrt_times(smooth, smooth_grad):
    """d/d(last time) against a forward difference (h = 1e-9, rtol 1e-3),
    as ``tests/test_adjoint.py:81-94``."""
    _, tm = smooth
    value, grads = smooth_grad
    assert grads["times"].shape == TIMES.shape
    tp = TIMES.copy()
    tp[-1] += 1e-9
    fd = (_value(tm, tm.control, tm.prop, tp) - value) / 1e-9
    np.testing.assert_allclose(grads["times"][-1], fd, rtol=1e-3)


def test_taylor_convergence_reads_order_2(smooth, smooth_grad):
    """The port's ``misc.taylor.taylor_convergence`` on the loss as a
    function of emod, with the adjoint's directional derivative: the
    remainder converges at order 2."""
    _, tm = smooth
    _, grads = smooth_grad
    emod0 = tm.prop["emod"].copy()
    dx = np.random.default_rng(7).standard_normal(emod0.shape) * 50.0

    def f(emod):
        return _value(tm, tm.control, {**tm.prop, "emod": emod}, TIMES)

    def jac(emod, d):
        assert emod is emod0
        return float(np.dot(grads["prop"]["emod"], d))

    errors, rates = taylor_convergence(emod0, dx, f, jac)
    assert np.all(np.isfinite(rates)) and np.all(np.abs(rates - 2.0) < 0.3), rates


def test_statefile_replay_matches_jax(smooth, tmp_path):
    """``adjoint.integrate`` of the port on a statefile written by the JAX
    package's ``forward.integrate`` (the shared schema) equals the JAX
    package's ``adjoint.integrate`` on that file: value to 1e-10, every
    gradient group per key to 1e-8 of its largest entry."""
    from vf_fem_tpu import statefile as jsf
    from vf_fem_tpu.functional.solid import FinalDisplacementNorm as JFinal
    from vf_fem_tpu_torch import statefile as tsf
    from vf_fem_tpu_torch.functional.solid import FinalDisplacementNorm as TFinal

    jm, tm = smooth
    times = 2e-5 * np.arange(6)
    ini = jm.state0.copy()
    ini[:] = 0.0
    path = str(tmp_path / "replay.h5")
    with jsf.StateFile(jm, path, mode="w") as f:
        jforward.integrate(jm, f, ini, [jm.control], jm.prop, times)
        vj, gj = jadjoint.integrate(jm, f, JFinal(jm))
    with tsf.StateFile(tm, path, mode="r") as f:
        func = TFinal(tm)
        vt, gt = adjoint.integrate(tm, f, func)
        np.testing.assert_allclose(vt, func(f), rtol=1e-10)
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    assert_grads_close(gt, gj, 1e-8, vj)


def test_newmark_step_backward_by_gradcheck():
    """K5's backward (the plain ``newmark_update_t_reference`` on the CPU)
    by ``torch.autograd.gradcheck`` of ``ops.newmark_step`` (v1, a1; the
    predictor is not differentiated), and against autograd of K5's plain
    forward on the same inputs: the vector cotangents to 1e-15 and the
    row's to 1e-13 (other summation orders)."""
    rng = np.random.default_rng(0)
    n = 11
    vecs = [torch.tensor(rng.standard_normal(n), requires_grad=True) for _ in range(4)]
    row = torch.tensor(newmark.coefficients(1e-2, 0.75e-2), dtype=torch.float64,
                       requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: ops.newmark_step(*a)[:2],
                                    (*vecs, row))
    vb1, ab1 = (torch.tensor(rng.standard_normal(n)) for _ in range(2))
    mine = torch.autograd.grad(ops.newmark_step(*vecs, row)[:2], (*vecs, row),
                               (vb1, ab1))
    plain = torch.autograd.grad(ops.newmark_update_coefs_reference(*vecs, row)[:2],
                                (*vecs, row), (vb1, ab1))
    for a, b in zip(mine[:4], plain[:4]):
        torch.testing.assert_close(a, b, rtol=1e-15, atol=1e-15 * float(b.abs().max()))
    torch.testing.assert_close(mine[4], plain[4], rtol=1e-13, atol=1e-13 * float(plain[4].abs().max()))
    # the predictor output carries no gradient
    assert not ops.newmark_step(*vecs, row)[2].requires_grad


def test_requires_grad_never_takes_the_step_graph(monkeypatch, smooth):
    """A run whose inputs require grad is the differentiable loop, even
    where a no-grad run would replay the captured step."""
    _, tm = smooth

    def refuse(*args, **kwargs):
        raise AssertionError("the gradient path took the step graph")

    monkeypatch.setattr(step_graph, "captures", lambda model, params: True)
    monkeypatch.setattr(step_graph, "integrate", refuse)
    s0, cs, prop = port_inputs(tm)
    prop_t = {k: torch.as_tensor(v) for k, v in prop.items()}
    prop_t["emod"].requires_grad_()
    fin, traj, info = forward.integrate_pure(tm, s0, cs, prop_t, TIMES[:4],
                                             {"fixed_iterations": 2}, use_remat=True)
    assert traj["u"].requires_grad
    with pytest.raises(AssertionError, match="step graph"):
        forward.integrate_pure(tm, s0, cs, prop, TIMES[:4], {"fixed_iterations": 2})


@pytest.mark.parametrize("config", ["dense", "btd"])
def test_backward_raises_no_version_error(config):
    """A fixed-iteration stale-factor run (the captured graph's settings on
    the card) differentiates without a version-counter error: no in-place
    write touches a tensor autograd saved."""
    if config == "dense":
        tm = port_vf_model("KelvinVoigtWEpithelium", 8, 4)
        params = {"jacobian_update": "once_per_step", "jacobian_refresh_steps": 3,
                  "jacobian_refresh_mode": "ns", "fixed_iterations": 2}
    else:
        tm = port_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
        params = {"linear_solver": "btd", "btd_store_dtype": "bfloat16",
                  "jacobian_refresh_steps": 3, "fixed_iterations": 3,
                  "fixed_tail_residual": False, "stagnation_ratio": 0.5}
    s0, cs, prop = port_inputs(tm)
    forward.integrate_pure(tm, s0, cs, prop, TIMES, params)  # the carry set by a forward
    value, grads = adjoint.integrate_grad(tm, _functional, s0, [tm.control], prop,
                                          TIMES, params)
    assert np.isfinite(value)
    assert all(np.isfinite(g).all() for g in grads["prop"].values())


def test_adjoint_solves_record_no_graph(monkeypatch):
    """The exact adjoint's factorization at u1 runs with grad mode off and
    returns factors that carry no graph (a graph kept alive by each step's
    factors would hold every step's factorization until the end of the
    backward pass)."""
    tm = port_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
    s0, _, prop = port_inputs(tm)
    seen = []
    make = tm.solid.make_iter_factors

    def spy(*args, **kwargs):
        fac = make(*args, **kwargs)
        seen.append((torch.is_grad_enabled(), any(t.requires_grad for t in fac
                                                  if isinstance(t, torch.Tensor))))
        return fac

    monkeypatch.setattr(tm.solid, "make_iter_factors", spy)
    params = {**CASES["btd-exact"][0], "jacobian_refresh_steps": 1}
    adjoint.integrate_grad(tm, _functional, s0, [tm.control], prop, TIMES[:4], params)
    backward = seen[-3:]  # the three steps' exact factorizations in backward
    assert len(seen) >= 6 and backward == [(False, False)] * 3, seen
