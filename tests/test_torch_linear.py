"""
Forward mode through the port's explicit-FSI loop
(``forward.integrate_linear`` / ``integrate_linear_pure``) against the JAX
package's ``integrate_linear`` (one ``jax.jvp`` through its scanned
integrator) on the CPU in f64, fed the same seeded numpy tangents:

- the forward-mode rules of the kernels' Functions: the banded gather and
  scatter (K1/K2 on the tangent) and K5's two launches, against
  ``torch.func.jvp`` of their plain versions;
- ``integrate_linear`` on a statefile written by the JAX package (the
  shared schema) against the JAX package's on the same file, rtol 1e-8;
  ``integrate_linear_pure`` with 'cg' and with bf16 'btd' factors (whose
  tangent solve takes f64 factors at u1) against the JAX jvp, rtol 1e-8,
  along initial-state, control, property and time tangents;
- the finite-difference check of ``tests/test_forward.py:135-174`` (psub,
  rtol 1e-4) and the jvp/vjp duality of ``tests/test_adjoint.py:97-136``
  (``integrate_linear_pure`` against ``adjoint.integrate_grad``, rtol
  1e-9).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jvp

from vf_fem_tpu import forward as jforward
from vf_fem_tpu import statefile as jsf
from vf_fem_tpu.residuals import fluid as jflr
from vf_fem_tpu_torch import adjoint, forward, ops
from vf_fem_tpu_torch import statefile as tsf
from vf_fem_tpu_torch.convert import from_blocks, to_blocks
from vf_fem_tpu_torch.fem import banded

from fixture_models import make_vf_fsi_model
from port_fixtures import jax_inputs, jax_vf_model, port_inputs, port_smooth_model, port_vf_model

TIMES = 2e-5 * np.arange(6)


def _tangents(s0, cs, prop, times, seed, dtimes=True):
    """Seeded tangents of the initial state, controls, properties (emod and
    ycontact) and, with ``dtimes``, the times after the first two."""
    rng = np.random.default_rng(seed)
    ds0 = {k: 1e-6 * rng.standard_normal(np.shape(v)) for k, v in s0.items()}
    dcs = {k: rng.standard_normal(np.shape(v)) for k, v in cs.items()}
    dprop = {k: np.zeros(np.shape(v)) for k, v in prop.items()}
    dprop["emod"] = 100.0 * rng.standard_normal(np.shape(prop["emod"]))
    dprop["ycontact"] = np.array([1e-3])
    dt = np.zeros(len(times))
    if dtimes:
        dt[2:] = 1e-7
    return ds0, dcs, dprop, dt


def _close(port: dict, ref: dict, rtol):
    for k, r in ref.items():
        r = np.asarray(r)
        p = port[k].numpy() if isinstance(port[k], torch.Tensor) else port[k]
        np.testing.assert_allclose(p, r, rtol=rtol, atol=rtol * np.abs(r).max(), err_msg=k)


def test_banded_rules_are_the_kernels_on_the_tangent():
    """Forward mode of ``banded_gather`` / ``banded_scatter`` (through their
    Functions, also without ``requires_grad``) is the same op on the
    tangent, and reverse mode still the other op."""
    tm = port_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
    plan = tm.solid.residual.banded_plan()
    n = tm.solid.nvert
    rng = np.random.default_rng(1)
    F, dF = (torch.as_tensor(rng.standard_normal((3, n))) for _ in range(2))
    loc, dloc = (torch.as_tensor(rng.standard_normal((plan.nv, 2, plan.ncpad)))
                 for _ in range(2))
    calls = []
    orig = banded._BandedGather.jvp

    def spy(ctx, *t):
        calls.append(1)
        return orig(ctx, *t)

    banded._BandedGather.jvp = staticmethod(spy)
    try:
        g, dg = jvp(lambda f: banded.banded_gather(plan, f), (F,), (dF,))
    finally:
        banded._BandedGather.jvp = staticmethod(orig)
    assert calls  # the Function's rule, not the plain version traced
    assert torch.equal(g, banded.banded_gather(plan, F))
    assert torch.equal(dg, banded.banded_gather(plan, dF))
    s, ds = jvp(lambda x: banded.banded_scatter(plan, x, n), (loc,), (dloc,))
    assert torch.equal(ds, banded.banded_scatter(plan, dloc, n))
    # the backward is unchanged: the gather's is the scatter with its offsets
    Fg = F.clone().requires_grad_()
    (gF,) = torch.autograd.grad(banded.banded_gather(plan, Fg), Fg, dg)
    assert torch.equal(gF, banded.banded_scatter_reference(plan, dg, n, plan.g))


def test_newmark_step_jvp_matches_plain():
    """K5's tangent (two launches of its plain version on the CPU and the
    a1 correction of the row's product c4 dt) against ``torch.func.jvp``
    of the plain Newmark relations, along the vectors and the row."""
    from vf_fem_tpu_torch.equations import newmark

    rng = np.random.default_rng(2)
    n = 13
    vecs = tuple(torch.as_tensor(rng.standard_normal(n)) for _ in range(4))
    dvecs = tuple(torch.as_tensor(rng.standard_normal(n)) for _ in range(4))
    dts = torch.tensor([1e-2, 0.75e-2], dtype=torch.float64)
    ddts = torch.tensor([1e-4, -2e-4], dtype=torch.float64)
    rows, drows = jvp(newmark.coefficient_rows, (dts,), (ddts,))
    row, drow = rows[0], drows[0]
    mine = jvp(lambda *a: ops.newmark_step(*a)[:2], (*vecs, row), (*dvecs, drow))[1]
    plain = jvp(lambda *a: ops.newmark_update_coefs_reference(*a)[:2], (*vecs, row),
                (*dvecs, drow))[1]
    for a, b in zip(mine, plain):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13 * float(b.abs().max()))


@pytest.fixture(scope="module")
def default_models():
    return jax_vf_model("KelvinVoigt", 8, 4), port_vf_model("KelvinVoigt", 8, 4)


def test_integrate_linear_on_a_jax_statefile(default_models, tmp_path):
    """Both packages' ``integrate_linear`` on one statefile (written by the
    JAX package's ``forward.integrate``), default solver parameters, along
    seeded state, control, property and time tangents: rtol 1e-8."""
    jm, tm = default_models
    ini = jm.state0.copy()
    ini[:] = 0.0
    s0, cs, prop = port_inputs(tm)
    ds0, dcs, dprop, dtimes = _tangents(s0, cs, prop, TIMES, 3)
    dcontrol = {k: v[0] for k, v in dcs.items()}
    path = str(tmp_path / "lin.h5")
    with jsf.StateFile(jm, path, mode="w") as f:
        jforward.integrate(jm, f, ini, [jm.control], jm.prop, TIMES)
        jd = jforward.integrate_linear(
            jm, f, to_blocks(ds0, jm.state0), [to_blocks(dcontrol, jm.control)],
            to_blocks(dprop, jm.prop), dtimes)
    with tsf.StateFile(tm, path, mode="r") as f:
        td = forward.integrate_linear(tm, f, ds0, [dcontrol], dprop, dtimes)
    assert list(td) == list(tm.state0)
    _close(td, from_blocks(jd), 1e-8)


@pytest.mark.parametrize("solver", ["cg", "btd"])
def test_integrate_linear_pure_matches_jax(solver):
    """``integrate_linear_pure`` with the Krylov solver 'cg' (tolerance
    1e-12) and with bf16 block-Thomas factors (the tangent solve takes f64
    factors built at u1, as the JAX package's rule) on the RCM mesh, against
    ``jax.jvp`` of the JAX package's forward-mode integrator: rtol 1e-8."""
    jm = jax_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
    tm = port_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
    params = ({"linear_solver": "cg", "krylov_tolerance": 1e-12} if solver == "cg"
              else {"linear_solver": "btd", "btd_store_dtype": "bfloat16"})
    s0, cs, prop = jax_inputs(jm)
    tangents = _tangents(s0, cs, prop, TIMES, 4)

    def run(*a):
        return jforward.integrate_pure(jm, *a, params, mode="fwd")[0]

    _, jd = jax.jvp(run, (s0, cs, prop, jnp.asarray(TIMES)),
                    tuple(jnp.asarray(t) if not isinstance(t, dict) else t for t in tangents))
    ts0, tcs, tprop = port_inputs(tm)
    before = dict(ops.LAUNCHES)
    fin, td = forward.integrate_linear_pure(tm, ts0, tcs, tprop, TIMES, *tangents, params)
    assert ops.LAUNCHES == before  # CPU tensors: the plain versions
    _close(td, jd, 1e-8)
    # the primal run is the forward's
    ref, _, _ = forward.integrate_pure(tm, ts0, tcs, tprop, TIMES, params)
    _close(fin, {k: v.numpy() for k, v in ref.items()}, 1e-12)


@pytest.fixture(scope="module")
def smooth():
    jm = make_vf_fsi_model(FluidResidual=jflr.BernoulliSmoothMinSep, nx=8, ny=4)
    return port_smooth_model(jm)


def test_integrate_linear_matches_fd(smooth):
    """The psub tangent against central differences of the forward run
    (h = 1 Ba), u, q and p at rtol 1e-4 (``tests/test_forward.py:135-174``)."""
    tm = smooth
    s0, cs, prop = port_inputs(tm)
    zeros = {k: np.zeros_like(v) for k, v in cs.items()}
    dcs = {**zeros, "psub": np.ones_like(cs["psub"])}
    _, td = forward.integrate_linear_pure(
        tm, s0, cs, prop, TIMES, {k: np.zeros_like(v) for k, v in s0.items()}, dcs,
        {k: np.zeros_like(v) for k, v in prop.items()}, np.zeros_like(TIMES))
    fins = []
    for h in (1.0, -1.0):
        c = {k: v.copy() for k, v in cs.items()}
        c["psub"] = c["psub"] + h
        fins.append(forward.integrate_pure(tm, s0, c, prop, TIMES)[0])
    for k in ("u", "q", "p"):
        fd = ((fins[0][k] - fins[1][k]) / 2.0).numpy()
        np.testing.assert_allclose(td[k].numpy(), fd, rtol=1e-4, atol=1e-12)


def test_jvp_vjp_duality_through_the_loop(smooth):
    """<hy, J dx> = <J^T hy, dx> with J = d u_final / d emod, J dx by
    ``integrate_linear_pure`` (the forward-mode IFT rule) and J^T hy by
    ``adjoint.integrate_grad`` (the reverse one), rtol 1e-9
    (``tests/test_adjoint.py:97-136``)."""
    tm = smooth
    times = TIMES[:5]
    s0, cs, prop = port_inputs(tm)
    rng = np.random.default_rng(2)
    dx = rng.standard_normal(prop["emod"].shape)
    hy = torch.as_tensor(rng.standard_normal(tm.solid.ndof))
    dprop = {k: np.zeros_like(v) for k, v in prop.items()}
    dprop["emod"] = dx
    _, td = forward.integrate_linear_pure(
        tm, s0, cs, prop, times, {k: np.zeros_like(v) for k, v in s0.items()},
        {k: np.zeros_like(v) for k, v in cs.items()}, dprop, np.zeros_like(times))
    _, g = adjoint.integrate_grad(
        tm, lambda traj, c, p, t: torch.dot(hy, traj["u"][-1]), s0, [tm.control], prop, times)
    lhs = float(torch.dot(hy, td["u"]))
    rhs = float(np.dot(g["prop"]["emod"], dx))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9)
