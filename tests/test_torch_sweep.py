"""
Batched parameter sweeps (``vf_fem_tpu_torch.parallel.sweep``, BASELINE
config 5) against the JAX package's ``sweep_integrate`` and vmapped
``value_and_grad`` (``tests/data/golden_sweep.npz``, written by
``tests/make_golden_sweep.py`` from the cases of ``tests/test_parallel.py``),
a row of the batch against its variant run alone, the shape gradient
against central differences, the batched step graph against the batched
eager loop, and the batched K5 / K5T against their unbatched versions, on
the CPU in f64 (plain versions of the kernels).
"""

import os

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from vf_fem_tpu_torch import forward, ops, step_graph
from vf_fem_tpu_torch.equations import newmark
from vf_fem_tpu_torch.models.transient import solver_params
from vf_fem_tpu_torch.parallel import batch_mesh, stack_props, sweep_grad, sweep_integrate

from port_fixtures import newmark_gap, port_inputs, port_vf_model

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "data", "golden_sweep.npz"))
TIMES = GOLDEN["times"]
# the rows of test_parallel.py (the JAX package's sweep against its single
# run) and of its golden: rtol 1e-10, atol 1e-14 of the field's scale
# (max(1, max|field|): p, ~8e3 Ba, has entries that cancel to rounding
# noise, a few 1e-12)
RTOL, ATOL = 1e-10, 1e-14
# the port's values and gradients against the JAX package's: of each key's
# largest entry (both ~1e-15 on an x86-64 CPU)
GRAD_RTOL = 1e-10
FD_RTOL = 2e-5  # test_parallel.py:305
# a fixed-iteration run with refresh windows (bench.py:656-664 with the
# windows cut to 2 steps, so that a short run takes each branch)
WINDOWS = {"jacobian_refresh_steps": 2, "jacobian_refresh_mode": "ns",
           "jacobian_full_refresh_windows": 2, "stagnation_ratio": 0.5,
           "fixed_iterations": 2}


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _batch(prefix):
    return {k[len(prefix):]: GOLDEN[k] for k in GOLDEN.files if k.startswith(prefix)}


def _loss(traj, controls, prop, times):
    """test_parallel.py:281-285."""
    return torch.sum(traj["u"][-1] ** 2) * 1e4 + 1e-6 * torch.sum(traj["q"] ** 2)


@pytest.fixture(scope="module")
def stiff():
    model = port_vf_model(nx=6, ny=3, fluid="BernoulliSmoothMinSep")
    state0, cs, _ = port_inputs(model)
    return model, state0, cs, _batch("stiff_prop_")


@pytest.fixture(scope="module")
def shape():
    model = port_vf_model(solid="KelvinVoigtWShape", nx=6, ny=3, fluid="BernoulliSmoothMinSep")
    state0, cs, _ = port_inputs(model)
    return model, state0, cs, _batch("grad_prop_")


@pytest.fixture(scope="module")
def stiff_run(stiff):
    model, state0, cs, pb = stiff
    return sweep_integrate(model, state0, cs, pb, TIMES)


def test_stiffness_sweep_matches_jax(stiff, stiff_run):
    """The 8-variant stiffness sweep: the final state of every variant
    within rtol 1e-10, atol 1e-14 of the JAX package's (v and a once the
    share of u's rounding gap that the Newmark relations carry into them,
    scaled by 2/dt and 4/dt^2, is taken out, as in test_torch_integrate.py),
    the trajectory of u at the same tolerance (atol of the field's scale,
    see ATOL), the Newton counts exact and
    the residual norms below the absolute tolerance wherever the JAX
    package's are (both at the rounding floor, ~1e-12)."""
    model, state0, cs, pb = stiff
    fin, infos = stiff_run
    _, traj, infos_b = forward.integrate_batch_pure(model, state0, cs, pb, TIMES,
                                                    {"assembly": "plain"})
    _close(traj["u"].numpy(), GOLDEN["stiff_traj_u"], "traj u")
    u = traj["u"].numpy()
    du = np.concatenate([np.zeros_like(u[:, :1]), u - GOLDEN["stiff_traj_u"]], axis=1)
    for b in range(u.shape[0]):
        gap = newmark_gap(du[b], 0.0, 0.0, float(TIMES[1] - TIMES[0]))
        for k in fin:
            got = fin[k][b].numpy() - (gap[k][-1] if k in gap else 0.0)
            _close(got, GOLDEN[f"stiff_fin_{k}"][b], f"{k}[{b}]")
    np.testing.assert_array_equal(infos.num_iter.numpy(), GOLDEN["stiff_info_num_iter"])
    for k in ("abs_err", "rel_err"):
        np.testing.assert_array_equal(getattr(infos_b, k).numpy(), getattr(infos, k).numpy())
    small = GOLDEN["stiff_info_abs_err"] < 1e-8
    assert (infos.abs_err.numpy()[small] < 1e-8).all()
    assert np.unique(fin["u"].numpy()[:, np.abs(fin["u"][0].numpy()) > 0], axis=0).shape[0] == 8


def test_sweep_row_equals_single_run(stiff, stiff_run):
    """Row 3 of the sweep against ``integrate_pure`` of variant 3 alone
    (test_parallel.py:56-62), every field."""
    model, state0, cs, pb = stiff
    fin, _ = stiff_run
    fin3, _, _ = forward.integrate_pure(model, state0, cs, {k: v[3] for k, v in pb.items()},
                                        TIMES, {"assembly": "plain"})
    for k in fin3:
        _close(fin[k][3].numpy(), fin3[k].numpy(), k)


def test_mesh_of_two_cpu_devices(stiff, stiff_run):
    """A mesh of two CPU devices (the model's device twice) gives the rows
    of no mesh; a mesh with another device raises (the split over several
    devices is not ported); without a CUDA device ``batch_mesh`` raises
    unless given the devices."""
    model, state0, cs, pb = stiff
    mesh = batch_mesh(devices=["cpu", "cpu"])
    fin, infos = sweep_integrate(model, state0, cs, pb, TIMES, mesh=mesh)
    ref, ref_infos = stiff_run
    for k in ref:
        assert torch.equal(fin[k], ref[k]), k
    assert torch.equal(infos.num_iter, ref_infos.num_iter)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch_mesh()
    with pytest.raises(NotImplementedError, match="is not ported"):
        sweep_integrate(model, state0, cs, pb, TIMES, mesh=[torch.device("meta")])


def test_batch_controls(stiff, stiff_run):
    """``batch_controls``: each variant's own controls; the same controls
    for every variant give the unbatched-controls rows."""
    model, state0, cs, pb = stiff
    cb = {k: np.stack([v] * 8) for k, v in cs.items()}
    fin, _ = sweep_integrate(model, state0, cb, pb, TIMES, batch_controls=True)
    for k, v in stiff_run[0].items():
        assert torch.equal(fin[k], v), k
    assert stack_props([{k: v[b] for k, v in pb.items()} for b in range(8)]).keys() == pb.keys()


def test_geometry_sweep_grad_matches_jax(shape):
    """The 4-variant geometry + stiffness ``value_and_grad``: values and the
    gradients in ``emod`` and ``umesh`` within 1e-10 of each key's largest
    entry of the JAX package's; variant 2's shape gradient against central
    differences of the port's own runs (test_parallel.py:296-305)."""
    model, state0, cs, pb = shape
    vals, grads = sweep_grad(model, _loss, state0, cs, pb, TIMES)
    ref = GOLDEN["grad_values"]
    np.testing.assert_allclose(vals.numpy(), ref, rtol=0, atol=GRAD_RTOL * np.abs(ref).max())
    assert np.unique(vals.numpy()).size == 4
    for k in ("emod", "umesh"):
        ref = GOLDEN[f"grad_{k}"]
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(), err_msg=k)

    def loss(p):
        _, traj, _ = forward.integrate_pure(model, state0, cs, p, TIMES, {"assembly": "plain"})
        return float(_loss(traj, cs, p, TIMES))

    g_um = grads["umesh"].numpy()
    dh = np.random.default_rng(3).standard_normal(g_um.shape[1])
    dh /= np.linalg.norm(dh)
    h = 1e-6
    pv = {k: v[2] for k, v in pb.items()}
    fd = (loss({**pv, "umesh": pv["umesh"] + h * dh})
          - loss({**pv, "umesh": pv["umesh"] - h * dh})) / (2 * h)
    np.testing.assert_allclose(float(g_um[2] @ dh), fd, rtol=FD_RTOL)


@pytest.mark.parametrize("assembly", ["plain", "banded"])
def test_batched_graph_step_matches_eager(stiff, assembly):
    """A fixed-iteration run with refresh windows: the step of the batched
    graph (``step_graph.integrate`` with a batch, uncaptured on the CPU)
    against the batched eager loop bit for bit, and each row against its
    variant run alone."""
    model, state0, cs, pb = stiff
    params = solver_params({**WINDOWS, "assembly": assembly})
    times = TIMES[1] * np.arange(8)
    ref = forward._integrate_eager(model, state0, cs, pb, times, params, (8, False))
    got = step_graph.integrate(model, state0, cs, pb, times, params, (8, False))
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
        assert torch.equal(got[1][k], ref[1][k]), k
    for a, b in zip(got[2], ref[2]):
        assert torch.equal(a, b)
    fin, traj, infos = forward.integrate_batch_pure(model, state0, cs, pb, times, params)
    assert traj["u"].shape == (8, 7, model.solid.ndof) and infos.num_iter.shape == (8, 7)
    one, _, _ = forward.integrate_pure(model, state0, cs, {k: v[5] for k, v in pb.items()},
                                       times, params)
    for k in one:
        _close(fin[k][5].numpy(), one[k].numpy(), k)


def test_refresh_precision(stiff):
    """``jacobian_refresh_precision``: the values the JAX package takes are
    accepted and compute the same IEEE products ('default' bit-equal to
    None); any other raises."""
    model, state0, cs, pb = stiff
    times = TIMES[1] * np.arange(6)
    pb2 = {k: v[:2] for k, v in pb.items()}
    runs = {p: forward.integrate_batch_pure(model, state0, cs, pb2, times,
                                            {**WINDOWS, "jacobian_refresh_precision": p})[0]
            for p in (None, "default", "high", "highest")}
    for p, fin in runs.items():
        for k in fin:
            assert torch.equal(fin[k], runs[None][k]), (p, k)
    for bad in ("bfloat16", "tensorfloat32", "fastest"):
        with pytest.raises(NotImplementedError, match="jacobian_refresh_precision"):
            solver_params({"jacobian_refresh_precision": bad})


def test_batch_refuses_other_solvers_and_implicit(stiff):
    model, state0, cs, pb = stiff
    with pytest.raises(NotImplementedError, match="linear_solver='dense' only"):
        sweep_integrate(model, state0, cs, pb, TIMES, {"linear_solver": "btd"})
    imp = port_vf_model(nx=6, ny=3, fluid="BernoulliSmoothMinSep", coupling="implicit")
    s0, c0, _ = port_inputs(imp)
    with pytest.raises(NotImplementedError, match="implicitly coupled"):
        sweep_integrate(imp, s0, c0, pb, TIMES)


def _newmark_inputs(B=5, n=37, seed=0):
    rng = np.random.default_rng(seed)
    vecs = [torch.as_tensor(rng.standard_normal((B, n))) for _ in range(6)]
    row = ops.newmark_row(newmark.coefficients(1e-4, 2e-4), torch.float64, "cpu")
    return vecs, row


def test_newmark_vmap_rule_is_the_loop():
    """K5's vmap rule (a batch of vectors under one row is one call over all
    of them) and the (B, n) wrapper against the unbatched calls, bit for
    bit; a batched row raises."""
    (u1, u0, v0, a0, _, _), row = _newmark_inputs()
    got = vmap(ops.newmark_step, in_dims=(0, 0, 0, 0, None))(u1, u0, v0, a0, row)
    flat = ops.newmark_update_coefs(u1, u0, v0, a0, row)
    for b in range(u1.shape[0]):
        one = ops.newmark_update_coefs(u1[b], u0[b], v0[b], a0[b], row)
        for g, f, o in zip(got, flat, one):
            assert torch.equal(g[b], o) and torch.equal(f[b], o)
    half = vmap(ops.newmark_step, in_dims=(0, None, 0, 0, None))(u1, u0[0], v0, a0, row)
    assert torch.equal(half[0][2], ops.newmark_update_coefs(u1[2], u0[0], v0[2], a0[2], row)[0])
    with pytest.raises(NotImplementedError, match="one coefficient row"):
        vmap(ops.newmark_step)(u1, u0, v0, a0, row.expand(5, -1))


def test_batched_plain_newmark_t_is_the_loop():
    """The batched plain K5T (a row cotangent a variant) against B
    unbatched calls, bit for bit; a vmapped gradient through
    ``ops.newmark_step`` takes it (its vmap rule) and gives each variant's
    gradient, the row's included; the gradient of a (B, n) batch under one
    row gets the batch's sum."""
    (u1, u0, v0, a0, vb1, ab1), row = _newmark_inputs(seed=1)
    got = ops.newmark_update_t_batch(vb1, ab1, u1, u0, v0, a0, row)
    assert got[4].shape == (5, newmark.NCOEFS)
    for b in range(u1.shape[0]):
        one = ops.newmark_update_t(vb1[b], ab1[b], u1[b], u0[b], v0[b], a0[b], row)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)

    def f(u1_, row_):
        v1, a1, _ = ops.newmark_step(u1_, u0[0], v0[0], a0[0], row_)
        return (v1 * vb1[0]).sum() + (a1 * ab1[0]).sum()

    g_u, g_row = vmap(grad(f, argnums=(0, 1)), in_dims=(0, None))(u1, row)
    assert g_row.shape == (5, newmark.NCOEFS)
    for b in range(u1.shape[0]):
        leaves = (u1[b].clone().requires_grad_(), row.clone().requires_grad_())
        one = torch.autograd.grad(f(*leaves), leaves)
        torch.testing.assert_close(g_u[b], one[0], rtol=0, atol=0)
        torch.testing.assert_close(g_row[b], one[1], rtol=1e-15, atol=0)
    leaves = (u1.clone().requires_grad_(), row.clone().requires_grad_())
    v1, a1, _ = ops.newmark_step(leaves[0], u0, v0, a0, leaves[1])
    g = torch.autograd.grad((v1 * vb1).sum() + (a1 * ab1).sum(), leaves)
    torch.testing.assert_close(g[1], got[4].sum(0), rtol=0, atol=0)
