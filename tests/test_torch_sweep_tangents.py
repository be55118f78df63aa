"""
Tangents of a batch of variants (``forward.integrate_linear_batch_pure``:
``torch.func.jvp`` of the batched differentiable loop, each step's tangent
the forward-mode IFT rule of every variant at once,
``models.transient._SolveU1Batch``) on the 8-variant stiffness batch of
``tests/test_torch_sweep.py`` (``tests/data/golden_sweep.npz``), on the CPU
in f64: every row against the port's unbatched tangent of its variant
(rtol 1e-10), and one row against ``jax.jvp`` of the JAX package's
``integrate_pure`` (rtol 1e-8), the JAX package's tangent of its
``vmap``-ed sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu_torch import forward
from vf_fem_tpu_torch.models.transient import _SolveU1Batch

from port_fixtures import jax_inputs, jax_vf_model, port_inputs, port_vf_model
from test_torch_sweep import TIMES, _batch

ROW_RTOL = 1e-10  # a row alone: phase 19's gate for a row of the batch
JAX_RTOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch_tangent():
    """The model, its inputs, seeded tangents (a property tangent a
    variant) and the batched run's ``(fin, dfin)``."""
    model = port_vf_model(nx=6, ny=3, fluid="BernoulliSmoothMinSep")
    state0, cs, _ = port_inputs(model)
    pb = _batch("stiff_prop_")
    rng = np.random.default_rng(11)
    B = len(pb["emod"])
    ds0 = {k: 1e-6 * rng.standard_normal(np.shape(v)) for k, v in state0.items()}
    dcs = {k: rng.standard_normal(np.shape(v)) for k, v in cs.items()}
    dpb = {k: np.zeros(np.shape(v)) for k, v in pb.items()}
    dpb["emod"] = 100.0 * rng.standard_normal((B,) + np.shape(pb["emod"])[1:])
    dtimes = np.zeros(len(TIMES))
    dtimes[2:] = 1e-7
    calls = {"n": 0}
    jvp_rule = _SolveU1Batch.jvp

    def counted(ctx, *tangents):
        calls["n"] += 1
        return jvp_rule(ctx, *tangents)

    _SolveU1Batch.jvp = staticmethod(counted)
    try:
        out = forward.integrate_linear_batch_pure(model, state0, cs, pb, TIMES, ds0, dcs,
                                                  dpb, dtimes)
    finally:
        _SolveU1Batch.jvp = staticmethod(jvp_rule)
    assert calls["n"] == len(TIMES) - 1  # one batched rule a step
    return model, (state0, cs, pb), (ds0, dcs, dpb, dtimes), out


def _row(d, b):
    return {k: v[b] for k, v in d.items()}


def test_batch_tangent_rows_equal_each_variant(batch_tangent):
    model, (state0, cs, pb), (ds0, dcs, dpb, dtimes), (fin, dfin) = batch_tangent
    for b in range(len(pb["emod"])):
        f1, d1 = forward.integrate_linear_pure(model, state0, cs, _row(pb, b), TIMES, ds0,
                                               dcs, _row(dpb, b), dtimes)
        for k, ref in d1.items():
            ref = ref.numpy()
            err = np.abs(dfin[k][b].numpy() - ref).max()
            assert err <= ROW_RTOL * max(np.abs(ref).max(), 1e-300), (b, k, err)
            np.testing.assert_allclose(fin[k][b].numpy(), f1[k].numpy(), rtol=ROW_RTOL,
                                       atol=1e-14 * max(1.0, float(f1[k].abs().max())))


def test_batch_tangent_row_matches_jax(batch_tangent):
    """Row 3 against ``jax.jvp`` of the JAX package's forward-mode
    integrator on that variant (every field of the final state within rtol
    1e-8 of its largest entry)."""
    _, (_, _, pb), (ds0, dcs, dpb, dtimes), (_, dfin) = batch_tangent
    jm = jax_vf_model(nx=6, ny=3, fluid="BernoulliSmoothMinSep")
    s0, cs, prop = jax_inputs(jm)
    row = {k: np.asarray(v[3]) for k, v in pb.items()}
    prop = {k: row.get(k, np.asarray(v)) for k, v in prop.items()}
    dprop = {k: np.asarray(dpb[k][3]) if k in dpb else np.zeros(np.shape(v))
             for k, v in prop.items()}

    def run(*a):
        return jforward.integrate_pure(jm, *a, None, mode="fwd")[0]

    _, jd = jax.jvp(run, (s0, cs, prop, jnp.asarray(TIMES)),
                    (ds0, dcs, dprop, jnp.asarray(dtimes)))
    for k, ref in jd.items():
        ref = np.asarray(ref)
        err = np.abs(dfin[k][3].numpy() - ref).max()
        assert err <= JAX_RTOL * np.abs(ref).max(), (k, err)
