"""
A batch of variants on the SPIKE solver (``linear_solver='spike'``, 4
partitions; ``parallel.sweep``) against the JAX package's
``sweep_integrate`` / ``sweep_grad`` (``tests/data/golden_sweep_solvers.npz``,
``tests/make_golden_sweep_solvers.py``) and against the port's own
unbatched runs, on the CPU in f64, on ``tests/test_torch_spike.py``'s FSI
model (KelvinVoigt + BernoulliSmoothMinSep on ``rcm_mesh(vocal_fold_mesh(10,
5))``): f64 factors against the JAX package at rtol 1e-8 and each row
against its variant's unbatched run at rtol 1e-10, bf16 factors against the
JAX package within 10x their measured difference, the step that the card
captures run uncaptured on the CPU, ``sweep_grad`` against the JAX
package's, one tangent row against its variant's; and the plain version of
K6 / K6T over a batch of slabs, (B, S, m, Bt, Bt) factors, against B S
unbatched sweeps bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import sweep_solver_cases as sc
from vf_fem_tpu_torch import forward, ops, step_graph
from vf_fem_tpu_torch.models.transient import solver_params
from vf_fem_tpu_torch.parallel import sweep

from port_fixtures import port_inputs
from test_torch_sweep_btd import (JAX_RTOL, ROW_RTOL, assert_grads_close, assert_rows_alone,
                                  golden)

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "data", "golden_sweep_solvers.npz"))
B = sc.B
# max|x_port - x_jax| / max|x_jax| of the bf16 batch's final state over its
# variants, measured
# on a CPU (x86-64): the bf16 factors' f32 matvecs sum in another order in
# the two packages, and the fixed-3 chord carries what that changes; each
# field is held at 10x its difference (as PROD_SMALL_DIFF)
SPIKE_SMALL_DIFF = {"u": 5.141e-08, "v": 5.102e-07, "a": 2.271e-06, "q": 1.265e-09,
                    "p": 1.272e-08}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return sc.port_model("spike")


@pytest.fixture(scope="module")
def port_runs(model):
    out = {}
    s0, cs, prop = port_inputs(model)
    pb = sc.batch(prop)
    for name in ("spike_f64", "spike_bf16"):
        for k, v in golden(name, "prop").items():
            np.testing.assert_array_equal(pb[k], v, err_msg=k)
        fin, info = sweep.sweep_integrate(model, s0, cs, pb, sc.times_of(name, None),
                                          sc.CASES[name][3])
        out[name] = (fin, info, pb)
    return out


def test_f64_sweep_matches_jax(port_runs):
    """f64 factors: every variant's final state within rtol 1e-8 (atol
    1e-12 of the field's largest entry) of the JAX package's sweep."""
    fin, info, _ = port_runs["spike_f64"]
    np.testing.assert_array_equal(info.num_iter.numpy(), GOLDEN["spike_f64|num_iter"])
    for k, ref in golden("spike_f64", "fin").items():
        np.testing.assert_allclose(fin[k].numpy(), ref, rtol=JAX_RTOL,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)


def test_bf16_sweep_matches_jax(port_runs):
    """bf16 factors: each field's max|diff| / max|x| within 10x its
    measured difference to the JAX package's (``SPIKE_SMALL_DIFF``)."""
    fin, _, _ = port_runs["spike_bf16"]
    for k, ref in golden("spike_bf16", "fin").items():
        for b in range(B):
            err = np.abs(fin[k][b].numpy() - ref[b]).max() / np.abs(ref[b]).max()
            assert err <= 10 * SPIKE_SMALL_DIFF[k], (k, b, err)


@pytest.mark.parametrize("name", ["spike_f64", "spike_bf16"])
def test_rows_equal_unbatched(model, port_runs, name):
    """Each row against its variant's unbatched run (rtol 1e-10)."""
    fin, _, pb = port_runs[name]
    assert_rows_alone(model, fin, pb, sc.times_of(name, None), sc.CASES[name][3], range(B))


def test_graph_step_matches_eager(model):
    """The step that the card captures (uncaptured on the CPU, the batch's
    SPIKE factors copied into its buffers each window; the transposed
    parts of a forward run stay None) against the batched eager loop, bit
    for bit."""
    s0, cs, prop = port_inputs(model)
    params = solver_params({**sc.SPIKE_BF16, "assembly": "plain", "jacobian_refresh_steps": 4})
    times = sc.times_of("spike_f64", None)
    batch = (B, False)
    ref = forward._integrate_eager(model, s0, cs, sc.batch(prop), times, params, batch)
    got = step_graph.integrate(model, s0, cs, sc.batch(prop), times, params, batch)
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
        assert torch.equal(got[1][k], ref[1][k]), k
    for a, b in zip(got[2], ref[2]):
        assert torch.equal(a, b)


def test_sweep_grad_matches_jax(model):
    """``sweep_grad`` (f64 factors with their transposed parts, refresh 4
    over 6 steps, stale adjoint) against the JAX package's: the values and
    every property's gradient within rtol 1e-8 of each one's largest
    entry."""
    s0, cs, prop = port_inputs(model)
    vals, grads = sweep.sweep_grad(model, sc.fsi_loss(torch), s0, cs, sc.batch(prop),
                                   sc.times_of("spike_grad", None), sc.CASES["spike_grad"][3])
    ref = GOLDEN["spike_grad|values"]
    np.testing.assert_allclose(vals.numpy(), ref, rtol=0, atol=JAX_RTOL * np.abs(ref).max())
    assert_grads_close(grads, "spike_grad", sc.batch(prop))


def test_tangent_row_equals_unbatched(model):
    """``integrate_linear_batch_pure`` on the bf16 SPIKE settings: row 0
    against ``integrate_linear_pure`` of its variant at rtol 1e-10."""
    s0, cs, prop = port_inputs(model)
    pb = {k: v[:2] for k, v in sc.batch(prop).items()}
    times = sc.times_of("spike_grad", None)
    rng = np.random.default_rng(7)
    dpb = {k: np.zeros(np.shape(v)) for k, v in pb.items()}
    dpb["emod"] = 100.0 * rng.standard_normal(np.shape(pb["emod"]))
    ds0 = {k: np.zeros(np.shape(v)) for k, v in s0.items()}
    dcs = {k: np.zeros(np.shape(v)) for k, v in cs.items()}
    params = {"assembly": "plain", **sc.SPIKE_BF16, "jacobian_refresh_steps": 4}
    _, dfin = forward.integrate_linear_batch_pure(model, s0, cs, pb, times, ds0, dcs, dpb,
                                                  np.zeros(len(times)), params)
    _, done = forward.integrate_linear_pure(model, s0, cs, {k: v[0] for k, v in pb.items()},
                                            times, ds0, dcs, {k: v[0] for k, v in dpb.items()},
                                            np.zeros(len(times)), params)
    for k in ("u", "q", "p"):
        np.testing.assert_allclose(dfin[k][0].numpy(), done[k].numpy(), rtol=ROW_RTOL,
                                   atol=1e-14 * done[k].abs().max().item(), err_msg=k)


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.float64), (torch.float64, torch.float64),
                                  (torch.float32, torch.float32)], ids=["bf16-f64", "f64", "f32"])
@pytest.mark.parametrize("transpose", [False, True], ids=["K6", "K6T"])
def test_plain_batched_slab_sweep_is_unbatched_sweeps(pair, transpose):
    """The plain version of K6 (K6T) over a batch of slabs, (B, S, m, Bt,
    Bt) factors, is B S unbatched plain sweeps, bit for bit, both
    directions (as ``tests/test_torch_spike.py`` holds it over slabs)."""
    fdt, vdt = pair
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.standard_normal((2, 3, 4, 128, 128)) * 0.05).to(fdt)
    g = torch.tensor(rng.standard_normal((2, 3, 4, 128))).to(vdt)
    sweep_fn = ops.btd_sweep_t if transpose else ops.btd_sweep
    for rev in (False, True):
        out = sweep_fn(A, g, reverse=rev)
        assert torch.equal(out, torch.stack([torch.stack([sweep_fn(A[b, s], g[b, s], reverse=rev)
                                                          for s in range(3)])
                                             for b in range(2)]))
