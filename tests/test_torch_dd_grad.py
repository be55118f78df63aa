"""
Gradients through the port's DOF-sharded explicit step
(``parallel.ddstep.DDIntegrator`` on inputs that require grad: its IFT
backward with the refined transposed SPIKE solve) on the CPU in f64, on
the 40 x 20 fold of ``tests/test_ddstep.py:123-167`` (4 shards, 8 steps of
5e-5 s, factors refreshed every 4 steps, ``1e4 sum(u_final^2) + 1e-6
sum(q^2)``), with the indexed and the banded cell pass:

- against the port's single-device gradient (refactored every step) at
  that test's gates: the value at rtol 1e-10, ``emod`` at rtol 1e-4 with
  atol 1e-7 max|g|, ``ymid`` at rtol 1e-6; and the times' gradient;
- against the JAX package's DD gradient of the same assembly and its
  single-device one, read from ``tests/data/golden_grad.npz`` (``python
  tests/make_golden_grad.py --only dd``: the JAX DD adjoint takes minutes
  to trace), at the same gates, and every property within 1e-6 of its
  largest entry of the JAX DD gradient;
- the value is the no-grad DD run's bit for bit, and the backward ran one
  refined adjoint solve a step.
"""

import os

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import forward
from vf_fem_tpu_torch.parallel import ddstep

from port_fixtures import port_dd_model, port_inputs

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_grad.npz")
TIMES = 5e-5 * np.arange(9)
SHARDS, REFRESH = 4, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small tensor ops a step: one thread (see
    ``tests/test_torch_ddstep.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss(fin, traj):
    return torch.sum(fin["u"] ** 2) * 1e4 + 1e-6 * torch.sum(traj["q"] ** 2)


def _value_grad(run, prop):
    """``(value, {key: grad})`` of :func:`_loss` over a run
    ``run(prop_leaves, times_leaf) -> (fin, traj, info)``, in every property
    and the times."""
    p = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in prop.items()}
    t = torch.tensor(TIMES, requires_grad=True)
    fin, traj, _ = run(p, t)
    value = _loss(fin, traj)
    grads = torch.autograd.grad(value, [*p.values(), t], allow_unused=True)
    return float(value.detach()), {k: (torch.zeros_like(x) if g is None else g).numpy()
                                   for k, x, g in zip([*p, "times"], [*p.values(), t], grads)}


@pytest.fixture(scope="module")
def model():
    return port_dd_model(40, 20)


@pytest.fixture(scope="module")
def single(model):
    """The port's single-device run, refactored every step (dense)."""
    s0, cs, prop = port_inputs(model)
    return _value_grad(lambda p, t: forward.integrate_pure(
        model, s0, cs, p, t, {"jacobian_refresh_steps": 1}), prop)


def _assert_gates(value, g, ref_value, ref):
    """``tests/test_ddstep.py:156-167``'s gates."""
    np.testing.assert_allclose(value, ref_value, rtol=1e-10)
    scale = np.abs(ref["emod"]).max()
    np.testing.assert_allclose(g["emod"], ref["emod"], rtol=1e-4, atol=1e-7 * scale)
    np.testing.assert_allclose(g["ymid"], ref["ymid"], rtol=1e-6)


@pytest.mark.parametrize("assembly", ["plain", "banded"])
def test_dd_grad_matches_single_device_and_jax(model, single, assembly):
    s0, cs, prop = port_inputs(model)
    dd = ddstep.DDIntegrator(model, SHARDS, {"jacobian_refresh_steps": REFRESH,
                                             "assembly": assembly})
    value, g = _value_grad(lambda p, t: dd.integrate_pure(s0, cs, p, t), prop)
    assert dd.adjoint_counts["solves"] == len(TIMES) - 1
    fin, traj, _ = dd.integrate_pure(s0, cs, prop, TIMES)
    assert float(_loss(fin, traj)) == value

    sv, sg = single
    _assert_gates(value, g, sv, sg)
    np.testing.assert_allclose(g["times"], sg["times"], rtol=1e-6,
                               atol=1e-6 * np.abs(sg["times"]).max())

    golden = np.load(GOLDEN)
    for name in (f"dd_{assembly}", "dd_single"):
        ref = {k: golden[f"{name}_grad_{k}"] for k in prop}
        _assert_gates(value, g, float(golden[f"{name}_value"]), ref)
    ref_value = float(golden[f"dd_{assembly}_value"])
    for k in prop:
        ref = golden[f"dd_{assembly}_grad_{k}"]
        scale, floor = np.abs(ref).max(), 1e-12 * abs(ref_value)
        if scale <= floor:  # a vanishing derivative's rounding
            assert np.abs(g[k]).max() <= floor, k
            continue
        assert np.abs(g[k] - ref).max() <= 1e-6 * scale, k
