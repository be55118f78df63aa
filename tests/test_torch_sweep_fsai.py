"""
A batch of variants of the two-way FSAI model (``models.fsai``'s batched
step functions; ``parallel.sweep``) on ``tests/test_fsai.py``'s 8 x 4 model
(12 tubes, the contact plane below the midline) with 3 emod variants, on
the CPU in f64: ``sweep_integrate`` against the JAX package's
(``tests/data/golden_sweep_solvers.npz``, ``tests/make_golden_sweep_solvers.py``:
u at rtol 1e-8, pref at rtol 1e-8 and atol 1e-10, as
``tests/test_ddstep.py:955-958`` holds a batch of FSAI variants), each row
against its variant's unbatched run (rtol 1e-10) with no lagged step, the
step that the card captures run uncaptured on the CPU against the batched
eager loop (``bracketed`` included), ``sweep_grad`` of the RMS radiated
pressure against the JAX package's (rtol 1e-8), the batched tangents row
by row against the unbatched ones (rtol 1e-10), and the envelope check of
a batch.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import sweep_solver_cases as sc
from vf_fem_tpu_torch import forward, step_graph
from vf_fem_tpu_torch.functional.acoustic import RmsRadiatedPressure
from vf_fem_tpu_torch.models.transient import solver_params
from vf_fem_tpu_torch.parallel import sweep

from port_fixtures import HEADLINE_SMALL, port_inputs
from test_torch_sweep_btd import (JAX_RTOL, ROW_RTOL, assert_grads_close, assert_rows_alone,
                                  golden)

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "data", "golden_sweep_solvers.npz"))
B = sc.B


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    tm = sc.port_model("fsai")
    assert tm.dt == float(GOLDEN["times_dt_fsai"])
    return tm


@pytest.fixture(scope="module")
def port_run(model):
    s0, cs, prop = port_inputs(model)
    pb = sc.batch(prop)
    for k, v in golden("fsai", "prop").items():
        np.testing.assert_array_equal(pb[k], v, err_msg=k)
    fin, info = sweep.sweep_integrate(model, s0, cs, pb, sc.times_of("fsai", model.dt))
    return fin, info, pb


def test_sweep_matches_jax(port_run):
    """Every variant's final u within rtol 1e-8 (atol 1e-12 of max|u|) and
    pref within rtol 1e-8, atol 1e-10 of the JAX package's sweep; q and p
    at rtol 1e-8; no lagged step in any variant."""
    fin, info, _ = port_run
    ref = golden("fsai", "fin")
    np.testing.assert_allclose(fin["u"].numpy(), ref["u"], rtol=JAX_RTOL,
                               atol=1e-12 * np.abs(ref["u"]).max())
    np.testing.assert_allclose(fin["pref"].numpy(), ref["pref"], rtol=JAX_RTOL, atol=1e-10)
    for k in ("q", "p", "pinc"):
        np.testing.assert_allclose(fin[k].numpy(), ref[k], rtol=JAX_RTOL,
                                   atol=1e-10 * max(1.0, np.abs(ref[k]).max()), err_msg=k)
    assert info.bracketed.shape == (B, len(sc.times_of("fsai", 1.0)) - 1)
    assert bool(info.bracketed.all())
    np.testing.assert_array_equal(info.num_iter.numpy(), GOLDEN["fsai|num_iter"])


def test_rows_equal_unbatched(model, port_run):
    """Each row against its variant's unbatched run (rtol 1e-10)."""
    fin, _, pb = port_run
    assert_rows_alone(model, fin, pb, sc.times_of("fsai", model.dt), {}, range(B))


def test_graph_step_matches_eager(model):
    """The step that the card captures (uncaptured on the CPU) on the
    headline settings, scaled down, against the batched eager loop, bit
    for bit, ``bracketed`` included."""
    s0, cs, prop = port_inputs(model)
    params = solver_params({**HEADLINE_SMALL, "assembly": "plain"})
    times = model.dt * np.arange(12)
    batch = (B, False)
    ref = forward._integrate_eager(model, s0, cs, sc.batch(prop), times, params, batch)
    got = step_graph.integrate(model, s0, cs, sc.batch(prop), times, params, batch)
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
        assert torch.equal(got[1][k], ref[1][k]), k
    for a, b in zip(got[2], ref[2]):
        assert torch.equal(a, b)
    assert got[2].bracketed.dtype == torch.bool


def test_sweep_grad_matches_jax(model):
    """``sweep_grad`` of the RMS radiated pressure over 20 steps against the
    JAX package's: the values and every property's gradient within rtol
    1e-8 of each one's largest entry (``assert_grads_close``: the smoothing
    widths' gradients are rounding noise in both)."""
    s0, cs, prop = port_inputs(model)
    loss = sc.fsai_loss(RmsRadiatedPressure(model), s0, torch)
    vals, grads = sweep.sweep_grad(model, loss, s0, cs, sc.batch(prop),
                                   sc.times_of("fsai_grad", model.dt))
    ref = GOLDEN["fsai_grad|values"]
    np.testing.assert_allclose(vals.numpy(), ref, rtol=0, atol=JAX_RTOL * np.abs(ref).max())
    assert np.abs(GOLDEN["fsai_grad|grad|emod"]).max() > 0
    assert_grads_close(grads, "fsai_grad", sc.batch(prop))


def test_tangents_equal_unbatched(model):
    """``integrate_linear_batch_pure`` (a property tangent a variant) row by
    row against ``integrate_linear_pure`` of each variant (rtol 1e-10): the
    root solve's polish and the tract vmapped, its detached bracketing and
    slope without a tangent."""
    s0, cs, prop = port_inputs(model)
    pb = sc.batch(prop)
    times = model.dt * np.arange(9)
    rng = np.random.default_rng(9)
    dpb = {k: np.zeros(np.shape(v)) for k, v in pb.items()}
    dpb["emod"] = 100.0 * rng.standard_normal(np.shape(pb["emod"]))
    dpb["area"] = 1e-2 * rng.standard_normal(np.shape(pb["area"]))
    ds0 = {k: np.zeros(np.shape(v)) for k, v in s0.items()}
    dcs = {k: np.ones(np.shape(v)) for k, v in cs.items()}
    _, dfin = forward.integrate_linear_batch_pure(model, s0, cs, pb, times, ds0, dcs, dpb,
                                                  np.zeros(len(times)))
    for b in range(B):
        _, done = forward.integrate_linear_pure(
            model, s0, cs, {k: v[b] for k, v in pb.items()}, times, ds0, dcs,
            {k: v[b] for k, v in dpb.items()}, np.zeros(len(times)))
        for k in done:
            np.testing.assert_allclose(dfin[k][b].numpy(), done[k].numpy(), rtol=ROW_RTOL,
                                       atol=1e-12 * max(done[k].abs().max().item(), 1e-300),
                                       err_msg=f"row {b} {k}")


def test_envelope_of_a_batch(model):
    """``check_envelope`` of a batch checks each variant: a variant whose
    contact plane lies above the midline warns, naming it; the batch inside
    the envelope does not."""
    _, _, prop = port_inputs(model)
    pb = sc.batch(prop)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert model.check_envelope(pb)
    pb["ycontact"][1] = pb["ymid"][1] + 0.01
    with pytest.warns(RuntimeWarning, match=r"variants \[1\]"):
        assert not model.check_envelope(pb)
