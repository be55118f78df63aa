"""
Tangents of the FSAI model (``forward.integrate_linear_pure`` on
``ExplicitFSAIModel``, the JAX package's ``step_pure_fwd``) against the JAX
package on the CPU in f64, on the 8 x 4 model of ``tests/test_fsai.py``
(KelvinVoigt + BernoulliSmoothMinSep, a 12-tube tract): the forward-mode
rule of the flow root solve (``solve_flow_root``: the root and the slope
``g'`` carry no tangent, the two polish steps do, so ``q_dot = -g_dot /
g'``) against ``jax.jvp`` of the JAX function, the tangent of a run
against ``jax.jvp`` of the JAX package's forward-mode integrator (rtol
1e-8), and its duality with ``adjoint.integrate_grad`` (rtol 1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from vf_fem_tpu import forward as jforward
from vf_fem_tpu.models.fsai import solve_flow_root as jsolve
from vf_fem_tpu_torch import adjoint, forward
from vf_fem_tpu_torch.models.fsai import solve_flow_root

from port_fixtures import jax_inputs, port_fsai_model, port_inputs, seeded_tangents
from test_fsai import make_fsai_model
from test_torch_fsai import _bernoulli_source

N_STEPS = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    jm = make_fsai_model(nx=8, ny=4)
    return jm, port_fsai_model(jm, nx=8, ny=4)


@pytest.mark.parametrize("q0", [120.0, 0.0, 1e5], ids=["near", "rest", "far"])
def test_solve_flow_root_tangent_matches_jax(q0):
    """The tangent of the root's fluid state along (z, b2, q0) against
    ``jax.jvp`` of the JAX package's function (rtol 1e-10): no tangent
    leaks from the bracketing or from the nested jvp of ``g'``."""
    z, b2, dz, db2, dq0 = 40.0, 500.0, 0.7, -3.0, 2.0

    def jrun(z_, b2_, q0_):
        return jsolve(_bernoulli_source(jnp, z_, b2_), q0_)[0]

    def trun(z_, b2_, q0_):
        return solve_flow_root(_bernoulli_source(torch, z_, b2_), q0_)[0]

    _, jd = jax.jvp(jrun, (jnp.asarray(z), jnp.asarray(b2), jnp.asarray([q0])),
                    (jnp.asarray(dz), jnp.asarray(db2), jnp.asarray([dq0])))
    t = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    _, td = jvp(trun, (t(z), t(b2), t([q0])), (t(dz), t(db2), t([dq0])))
    for k in ("q", "p"):
        ref = np.asarray(jd[k])
        np.testing.assert_allclose(td[k].numpy(), ref, rtol=1e-10,
                                   atol=1e-14 * np.abs(ref).max())


def test_fsai_tangent_matches_jax(small):
    """The run's tangent along seeded directions of the initial state, the
    controls, emod and the times against ``jax.jvp`` of the JAX package's
    ``integrate_pure(..., mode='fwd')``, every field of the final state at
    rtol 1e-8 of its largest entry."""
    jm, tm = small
    times = tm.dt * np.arange(N_STEPS + 1)
    s0, cs, prop = jax_inputs(jm)
    tangents = seeded_tangents(s0, cs, prop, times, 5)

    def run(*a):
        return jforward.integrate_pure(jm, *a, None, mode="fwd")[0]

    _, jd = jax.jvp(run, (s0, cs, prop, jnp.asarray(times)),
                    tuple(t if isinstance(t, dict) else jnp.asarray(t) for t in tangents))
    fin, td = forward.integrate_linear_pure(tm, *port_inputs(tm), times, *tangents)
    assert set(td) == set(tm.state0)
    for k, ref in jd.items():
        ref = np.asarray(ref)
        err = np.abs(td[k].numpy() - ref).max()
        assert err <= 1e-8 * np.abs(ref).max(), (k, err)
    # the primal is the forward's
    ref_fin, _, _ = forward.integrate_pure(tm, *port_inputs(tm), times)
    assert all(torch.equal(fin[k], ref_fin[k]) for k in fin)


def test_fsai_tangent_duality(small):
    """<hy, J dx> = <J^T hy, dx> with J = d(u, q)_final / d emod: J dx by
    ``integrate_linear_pure``, J^T hy by ``adjoint.integrate_grad``, rtol
    1e-8 (``chip_smoke.py`` phase 10's gate)."""
    _, tm = small
    times = tm.dt * np.arange(N_STEPS + 1)
    s0, cs, prop = port_inputs(tm)
    rng = np.random.default_rng(7)
    dx = rng.standard_normal(prop["emod"].shape)
    hu = torch.as_tensor(rng.standard_normal(tm.solid.ndof))
    hq = float(rng.standard_normal())
    dprop = {k: np.zeros_like(v) for k, v in prop.items()}
    dprop["emod"] = dx
    _, td = forward.integrate_linear_pure(
        tm, s0, cs, prop, times, {k: np.zeros_like(v) for k, v in s0.items()},
        {k: np.zeros_like(v) for k, v in cs.items()}, dprop, np.zeros_like(times))

    def functional(traj, c, p, t):
        return torch.dot(hu, traj["u"][-1]) + hq * traj["q"][-1].sum()

    _, g = adjoint.integrate_grad(tm, functional, s0, [tm.control], prop, times)
    lhs = float(torch.dot(hu, td["u"])) + hq * float(td["q"].sum())
    rhs = float(np.dot(g["prop"]["emod"], dx))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-8)
