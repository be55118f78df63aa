"""
The port's CUDA kernels on the card (``gpu`` marker; every test skips
without a CUDA device).  This file imports neither jax nor the JAX package,
so that it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import config, forward, ops
from vf_fem_tpu_torch.fem import banded
from vf_fem_tpu_torch.mesh import load_gmsh
from vf_fem_tpu_torch.ops import kernels
from vf_fem_tpu_torch.solvers import bsb

from bsb_emulation import emulate_bsb_matvec, emulate_bsb_matvec_t
from port_fixtures import (
    M5_PROPS, MESHES, assert_scatter_close, newmark_gap, port_dd_model, port_inputs,
    port_vf_model,
)
from sweep_emulation import emulate_sweep

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_fsi_explicit.npz")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["M5_3layers", "M5_3layers_rcm_h006"])
def plan(request, cuda):
    mesh = load_gmsh(os.path.join(MESHES, request.param + ".msh"))
    hp = banded.plan_banded(mesh.cells, mesh.num_vertices, gc=config.BANDED_GC)
    return banded.to_device(hp, cuda), mesh.num_vertices, hp


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain(plan, dtype):
    """K1/K2 against the plain versions on the same inputs, for both offset
    patterns: the gather exactly, the scatter to summation order (rtol
    1e-13 in f64, 1e-6 in f32, or within the summation-order bound)."""
    dp, nvert, _ = plan
    dev = dp.base.device
    rng = np.random.default_rng(0)
    F = torch.tensor(rng.standard_normal((11, nvert)), dtype=dtype, device=dev)
    loc = torch.tensor(rng.standard_normal((dp.nv, 11, dp.ncpad)), dtype=dtype,
                       device=dev)
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    n0 = dict(banded.LAUNCHES)
    for pattern in (dp.g, dp.s):
        torch.testing.assert_close(
            banded._gather(dp, F, pattern),
            banded.banded_gather_reference(dp, F, pattern), rtol=0, atol=0,
        )
        assert_scatter_close(
            banded._scatter(dp, loc, nvert, pattern),
            banded.banded_scatter_reference(dp, loc, nvert, pattern),
            banded.scatter_order_bound(dp, loc, nvert, pattern), rtol,
        )
    torch.cuda.synchronize()
    assert banded.LAUNCHES["gather"] == n0["gather"] + 2
    assert banded.LAUNCHES["scatter"] == n0["scatter"] + 2


def test_wrappers_reject_bad_input(plan):
    dp, nvert, _ = plan
    dev = dp.base.device
    F = torch.zeros((4, nvert), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        banded.banded_gather(dp, F.T.contiguous().T)
    with pytest.raises(TypeError):
        banded.banded_gather(dp, F.to(torch.float16))
    with pytest.raises(ValueError, match="plan on"):
        banded.banded_gather(dp, F.cpu())


def test_explicit_golden_on_cuda(cuda):
    """The small explicit-FSI golden in f64 on the card, through K1/K2."""
    data = np.load(GOLDEN)
    model = port_vf_model(device=cuda)
    state0, cs, prop = port_inputs(model)
    banded.LAUNCHES.update(gather=0, scatter=0)
    fin, traj, infos = forward.integrate_pure(model, state0, cs, prop,
                                              data["times"])
    torch.cuda.synchronize()
    assert min(banded.LAUNCHES.values()) > 0
    np.testing.assert_allclose(
        traj["u"].cpu().numpy()[::8], data["u"], rtol=1e-8, atol=1e-12
    )
    np.testing.assert_allclose(traj["q"].cpu().numpy().ravel(), data["q"],
                               rtol=1e-8)


# -- K3, K4, K5 and the Krylov path ---------------------------------------------


LARGE = os.path.join(MESHES, "M5_3layers_rcm_h006.msh")
GOLDEN_LARGE = os.path.join(os.path.dirname(__file__), "data",
                            "golden_large_bsb_explicit.npz")


@pytest.fixture(scope="module")
def large_f64(cuda):
    """The 23.7k-dof large-mesh model of bench.py on the card, f64."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    model = load_fsi_model(LARGE, slr.KelvinVoigtWEpithelium,
                           flr.BernoulliAreaRatioSep, device=cuda)
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    for k, v in dict(M5_PROPS, ycontact=ymax + 0.05, ymid=ymax + 0.01).items():
        model.prop[k][:] = v
    model.control["psub"][:] = 8000.0
    model.control["psup"][:] = 0.0
    return model


@pytest.fixture(scope="module")
def large_operator(large_f64):
    """The element-by-element Jacobian at rest under 500 Ba, and its
    block-banded array."""
    from vf_fem_tpu_torch.convert import to_tensors
    from vf_fem_tpu_torch.solvers import bsb

    model = large_f64
    s = model.solid
    z = torch.zeros(s.ndof, dtype=torch.float64, device=s.device)
    state0 = {"u": z, "v": z, "a": z}
    control = {"p1": torch.full((s.nvert,), 500.0, dtype=torch.float64,
                                device=s.device)}
    prop = to_tensors({k: model.prop[k] for k in model._solid_prop_keys},
                      s.device, torch.float64)
    op = s.jac_u_ebe(z, state0, control, prop, 1e-4)
    plan, fill = s.bsb_plan()
    return op, plan, bsb.bsb_fill(plan, fill, [op.J_cells, op.J_facets])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ops_kernels_match_plain(large_f64, large_operator, dtype):
    """K3 (cells and facets), K4 and K5 against their plain versions on
    the card: rtol 1e-13 (f64) / 1e-6 (f32) per entry or within the
    summation-order bound of the dot products (``ops.dot_order_bound``);
    K5 rounds every operation as the plain version does."""
    op, plan, blocks = large_operator
    pattern = large_f64.solid.bsb_plan()[1].pattern
    dev = blocks.device
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal(plan.ndof), dtype=dtype, device=dev)
    n0 = dict(ops.LAUNCHES)
    for J, d in ((op.J_cells, op.cell_dofs), (op.J_facets, op.facet_dofs)):
        J = J.to(dtype)
        bound = ops.dot_order_bound(
            ops.ebe_matvec_reference(J.abs(), x.abs(), d), 6)
        assert_scatter_close(ops.ebe_matvec(J, x, d),
                             ops.ebe_matvec_reference(J, x, d), bound, rtol)
    B = blocks.to(dtype)
    bound = ops.dot_order_bound(
        ops.bsb_matvec_reference(plan, B.abs(), x.abs()), plan.nb * plan.b)
    assert_scatter_close(ops.bsb_matvec(plan, B, x, pattern),
                         ops.bsb_matvec_reference(plan, B, x), bound, rtol)
    u1, u0, v0, a0 = (torch.tensor(rng.standard_normal(plan.ndof),
                                   dtype=dtype, device=dev) for _ in range(4))
    outs = ops.newmark_update(u1, u0, v0, a0, 1e-4)
    refs = ops.newmark_update_reference(u1, u0, v0, a0, 1e-4)
    assert len(outs) == 3
    assert all(torch.equal(out, ref) for out, ref in zip(outs, refs))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ebe_matvec"] == n0["ebe_matvec"] + 2
    assert ops.LAUNCHES["bsb_matvec"] == n0["bsb_matvec"] + 1
    assert ops.LAUNCHES["newmark"] == n0["newmark"] + 1


def _newmark_inputs(n, layout, dtype, dev, seed=0):
    """u1, u0, v0, a0 of ``n`` entries: each its own allocation
    ('aligned'), views one entry into theirs ('view'), or views at offsets
    1, 2, 3, 0 (mixed 16-byte phases: K5's scalar path)."""
    host = np.random.default_rng(seed).standard_normal((4, n + 3))
    full = [torch.tensor(h, dtype=dtype, device=dev) for h in host]
    offsets = {"aligned": (0, 0, 0, 0), "view": (1, 1, 1, 1), "mixed": (1, 2, 3, 0)}[layout]
    return [f[k:k + n] for f, k in zip(full, offsets)]


@pytest.mark.parametrize("layout", ["aligned", "view", "mixed"])
@pytest.mark.parametrize("n", [960, 23_754, 123])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_bit_equal(cuda, dtype, n, layout):
    """K5's three outputs (v1, a1 and the next step's predictor) equal the
    plain version's bit for bit, one launch each, also with a predictor
    step other than the update's."""
    args = _newmark_inputs(n, layout, dtype, cuda)
    n0 = ops.LAUNCHES["newmark"]
    for dt_next in (None, 7.5e-5):
        outs = ops.newmark_update(*args, 1e-4, dt_next=dt_next)
        refs = ops.newmark_update_reference(*args, 1e-4, dt_next=dt_next)
        torch.cuda.synchronize()
        assert len(outs) == 3
        for out, ref in zip(outs, refs):
            assert out.is_contiguous() and tuple(out.shape) == (n,)
            assert torch.equal(out, ref)
    assert ops.LAUNCHES["newmark"] == n0 + 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_graph_replay_equals_eager(cuda, dtype):
    """K5 captured in a CUDA graph: a replay on new inputs (written in
    place) gives the eager launch's bits."""
    args = _newmark_inputs(23_754, "aligned", dtype, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.newmark_update(*args, 1e-4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.newmark_update(*args, 1e-4)
    for a, b in zip(args, _newmark_inputs(23_754, "aligned", dtype, cuda, seed=1)):
        a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    n0 = ops.LAUNCHES["newmark"]
    eager = ops.newmark_update(*args, 1e-4)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["newmark"] == n0 + 1
    assert all(torch.equal(c, e) for c, e in zip(captured, eager))
    assert all(torch.equal(c, r) for c, r in
               zip(captured, ops.newmark_update_reference(*args, 1e-4)))


def test_newmark_carry_on_cuda(cuda):
    """On the card the solid takes K5's predictor at every step after the
    first; the run is bit-identical to one whose steps form it."""
    model = port_vf_model("KelvinVoigtWEpithelium", device=cuda)
    state0, cs, prop = port_inputs(model)
    times = 1e-4 * np.arange(11)
    params = {"fixed_iterations": 2, "jacobian_update": "once_per_step"}
    fin, traj, _ = forward.integrate_pure(model, state0, cs, prop, times, params)
    # two predictors a step: the factors' and the Newton guess
    assert model.solid.predictor_counts == {"carried": 18, "formed": 2}
    step = model.step_pure

    def cloned(state, *args, **kw):
        return step({k: v.clone() for k, v in state.items()}, *args, **kw)

    model.step_pure = cloned
    _, ref, _ = forward.integrate_pure(model, state0, cs, prop, times, params)
    assert all(torch.equal(traj[k], ref[k]) for k in traj)


def test_ops_wrappers_reject_bad_input(large_f64, large_operator):
    op, plan, blocks = large_operator
    pattern = large_f64.solid.bsb_plan()[1].pattern
    x = torch.zeros(plan.ndof, dtype=torch.float64, device=blocks.device)
    n0 = ops.LAUNCHES["bsb_matvec"]
    with pytest.raises(ValueError, match="contiguous"):
        ops.bsb_matvec(plan, blocks.transpose(2, 3), x, pattern)
    with pytest.raises(ValueError, match="tensors on"):
        ops.bsb_matvec(plan, blocks, x.cpu(), pattern)
    # K4 has no dense-band fallback: without the pattern it raises
    with pytest.raises(ValueError, match="pattern"):
        ops.bsb_matvec(plan, blocks, x)
    with pytest.raises(ValueError, match="pattern.ptr"):
        ops.bsb_matvec(plan, blocks, x, pattern._replace(ptr=pattern.ptr.long()))
    with pytest.raises(ValueError, match="aligned"):
        ops.bsb_matvec(plan, blocks, torch.zeros(plan.ndof + 1, dtype=x.dtype,
                                                 device=x.device)[1:], pattern)
    # a launch the card refuses (an x window past the shared memory) raises
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels._bsb_launch(plan._replace(nb=401), blocks, x, pattern)
    assert ops.LAUNCHES["bsb_matvec"] == n0
    with pytest.raises(TypeError):
        ops.ebe_matvec(op.J_cells.float(), x, op.cell_dofs)
    n0 = ops.LAUNCHES["newmark"]
    with pytest.raises(ValueError, match="contiguous"):
        ops.newmark_update(x[::2], x[::2], x[::2], x[::2], 1e-4)
    with pytest.raises(ValueError, match="tensors on"):
        ops.newmark_update(x, x, x, x.cpu(), 1e-4)
    assert ops.LAUNCHES["newmark"] == n0


def _k4_fills(large_f64, large_operator):
    """The 23.7k model's own block-banded Jacobian and one filled from
    random element Jacobians, with the plan and its pattern."""
    _, plan, blocks = large_operator
    _, fill = large_f64.solid.bsb_plan()
    rng = np.random.default_rng(5)
    src = torch.tensor(rng.standard_normal(plan.tgt_idx.size), device=blocks.device)
    return plan, fill.pattern, {"model": blocks, "random": bsb.bsb_fill(plan, fill, [src])}


@pytest.mark.parametrize("fill", ["model", "random"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bsb_matvec_is_its_emulation(large_f64, large_operator, fill, dtype):
    """K4 at 23.7k, on the model's fill and on a fill from random element
    Jacobians: bit for bit the CPU emulation of its order
    (``tests/bsb_emulation.py``) and within rtol 1e-13 / 1e-6 plus the
    dot-product order bound of the plain (dense-band) version."""
    plan, pattern, fills = _k4_fills(large_f64, large_operator)
    B = fills[fill].to(dtype)
    x = torch.tensor(np.random.default_rng(6).standard_normal(plan.ndof), dtype=dtype,
                     device=B.device)
    y = ops.bsb_matvec(plan, B, x, pattern)
    emul = emulate_bsb_matvec(plan, bsb.matvec_pattern(plan), B.cpu().numpy(),
                              x.cpu().numpy(), kernels.BSB_LANES)
    assert np.array_equal(y.cpu().numpy(), emul)
    bound = ops.dot_order_bound(ops.bsb_matvec_reference(plan, B.abs(), x.abs()),
                                plan.nb * plan.b)
    assert_scatter_close(y, ops.bsb_matvec_reference(plan, B, x), bound,
                         1e-13 if dtype == torch.float64 else 1e-6)


def test_tight_bsb_matches_large_golden(large_f64):
    """The tight bsb run of the 23.7k model in f64 on the card against the
    JAX package's golden (rtol 1e-8 of max|u|), through K1, K2, K4, K5."""
    data = np.load(GOLDEN_LARGE)
    model = large_f64
    state0, cs, prop = port_inputs(model)
    banded.LAUNCHES.update(gather=0, scatter=0)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    fin, traj, infos = forward.integrate_pure(
        model, state0, cs, prop, data["times"],
        {"assembly": "banded", "linear_solver": "bsb",
         "krylov_tolerance": 1e-10, "krylov_max_iter": 1000,
         "jacobian_refresh_steps": 1},
    )
    torch.cuda.synchronize()
    assert min(banded.LAUNCHES.values()) > 0
    assert ops.LAUNCHES["bsb_matvec"] > 0 and ops.LAUNCHES["newmark"] > 0
    assert ops.LAUNCHES["ebe_matvec"] == 0
    every = int(data["steps"][0])
    u = traj["u"].cpu().numpy()[every - 1 :: every]
    assert np.abs(u - data["u"]).max() <= 1e-8 * np.abs(data["u"]).max()
    # the final acceleration amplifies the Krylov tolerance in u: gated at
    # 10x the port's bsb difference from the golden on a CPU (chip_smoke.py)
    for k, gate in (("v", 1e-8), ("a", 5.405e-8), ("q", 1e-8), ("p", 1e-8)):
        ref = data[f"{k}_final"]
        assert np.abs(fin[k].cpu().numpy() - ref).max() <= gate * np.abs(ref).max(), k


# -- K6 and the block-Thomas path ------------------------------------------------


SWEEP_PAIRS = {
    "bf16-f64": (torch.bfloat16, torch.float64),
    "bf16-f32": (torch.bfloat16, torch.float32),
    "f64-f64": (torch.float64, torch.float64),
    "f32-f32": (torch.float32, torch.float32),
    # btd_factor_dtype='float32' under f64 residuals, and fp8 stored factors
    "f32-f64": (torch.float32, torch.float64),
    "e4m3-f64": (torch.float8_e4m3fn, torch.float64),
    "e4m3-f32": (torch.float8_e4m3fn, torch.float32),
    "e5m2-f64": (torch.float8_e5m2, torch.float64),
    "e5m2-f32": (torch.float8_e5m2, torch.float32),
}


def _btd_factors(plan, blocks, fdt):
    """btd factors of ``blocks`` whose sweeps take factors of ``fdt``: f64,
    factored in f32 (``factor_dtype``), or stored bf16 / fp8."""
    from vf_fem_tpu_torch.solvers import btd

    if fdt == torch.float32:
        return btd.btd_factor(plan, blocks, factor_dtype="float32")
    store = {v: k for k, v in btd.STORE_DTYPES.items()}.get(fdt)
    return btd.btd_factor(plan, blocks, store_dtype=store)


@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_btd_sweep_matches_plain(large_operator, pair):
    """K6 against its plain version on the 23.7k model's own factors, both
    sweeps: each row within rtol 1e-13 (f64 vectors) / 1e-6 (f32) plus
    the dot-product order bound of the plain row computed from the
    kernel's own previous row; a btd solve on the card is two launches."""
    from vf_fem_tpu_torch.solvers import btd

    op, plan, blocks = large_operator
    fdt, vdt = SWEEP_PAIRS[pair]
    fac = _btd_factors(plan, blocks, fdt)
    assert fac.V.dtype == fdt
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.standard_normal(tuple(fac.V.shape[:2])), dtype=vdt,
                     device=blocks.device)
    rtol = 1e-13 if vdt == torch.float64 else 1e-6
    n0 = ops.LAUNCHES["btd_sweep"]
    for A, rev in ((fac.V, False), (fac.W, True)):
        out = ops.btd_sweep(A, g, reverse=rev)
        ref, bound = ops.btd_sweep_rows_reference(A, g, out, rev)
        assert_scatter_close(out, ref, bound, rtol)
    r = torch.tensor(rng.standard_normal(plan.ndof), dtype=vdt, device=blocks.device)
    x = btd.btd_solve(plan, fac._replace(d=fac.d.to(vdt)), r)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())
    assert ops.LAUNCHES["btd_sweep"] == n0 + 4


def test_btd_sweep_rejects_bad_input(large_operator):
    _, _, blocks = large_operator
    dev = blocks.device
    A = torch.zeros((3, 256, 256), dtype=torch.bfloat16, device=dev)
    g = torch.zeros((3, 256), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.btd_sweep(A.transpose(1, 2), g)
    with pytest.raises(ValueError, match="tensors on"):
        ops.btd_sweep(A, g.cpu())
    with pytest.raises(TypeError):
        ops.btd_sweep(A.half(), g)
    with pytest.raises(ValueError, match="row blocks"):
        ops.btd_sweep(A[:, :16, :16].contiguous(), g[:, :16].contiguous())
    # a cluster size other than the kernel's own is refused at launch, and raises
    plan = ops.sweep_plan(256, A.dtype, g.dtype)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels._sweep_launch(A, g, False, plan._replace(cluster=4))


def _random_sweep(pair, bt, n, seed, dev):
    fdt, vdt = SWEEP_PAIRS[pair]
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.standard_normal((n, bt, bt)) * (0.5 / bt ** 0.5)).to(fdt)
    g = torch.tensor(rng.standard_normal((n, bt))).to(vdt)
    return A, g, A.to(dev), g.to(dev)


@pytest.mark.parametrize("n", [1, 2, 93])
@pytest.mark.parametrize("bt", kernels.SWEEP_WIDTHS)
@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_btd_sweep_rows_every_width(cuda, pair, bt, n):
    """K6 (its plan's cluster) on random factors scaled to 0.5/sqrt(Bt), both
    sweeps: each row within rtol 1e-13 (f64 vectors) / 1e-6 (f32) plus the
    dot-product order bound of the plain row from the kernel's own previous
    row; with bf16 factors (whose products the emulation sums exactly as
    the kernel's FMAs do) bit-equal to the CPU emulation of its schedule."""
    A, g, Ad, gd = _random_sweep(pair, bt, n, seed=bt + n, dev=cuda)
    rtol = 1e-13 if g.dtype == torch.float64 else 1e-6
    for rev in (False, True):
        out = ops.btd_sweep(Ad, gd, reverse=rev)
        ref, bound = ops.btd_sweep_rows_reference(Ad, gd, out, rev)
        assert_scatter_close(out, ref, bound, rtol)
        if A.dtype == torch.bfloat16:
            assert torch.equal(out.cpu(), emulate_sweep(A, g, rev))


@pytest.mark.parametrize("bt", kernels.SWEEP_WIDTHS)
@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_sweep_plan_is_the_kernels(cuda, pair, bt):
    """``ops.sweep_plan`` (the CPU tests' copy) is the plan compiled into
    ``csrc/btd.cu``."""
    fdt, vdt = SWEEP_PAIRS[pair]
    assert ops.sweep_plan(bt, fdt, vdt) == kernels.built_sweep_plan(bt, fdt)


@pytest.mark.parametrize("C", [2, 11])
def test_gather_zero_fill(plan, C):
    """K1 with 2 and 11 channels (the channel chunks differ with C):
    columns past F's own (F narrower than the plan) and padding slots read
    zero, exactly as the plain gather, on every call."""
    dp, nvert, _ = plan
    rng = np.random.default_rng(C)
    for n_cols in (nvert, nvert - 37):
        F = torch.tensor(rng.standard_normal((C, n_cols)), device=dp.base.device)
        for pattern in (dp.g, dp.s):
            ref = banded.banded_gather_reference(dp, F, pattern)
            for _ in range(2):
                torch.testing.assert_close(banded._gather(dp, F, pattern), ref,
                                           rtol=0, atol=0)


@pytest.mark.parametrize("C", [2, 11])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scatter_sums_in_csr_order(plan, C, dtype):
    """K2 sums each row in its CSR order, which is the order of the plain
    scatter on the CPU (sequential ``index_add_``): bit-equal to it, for
    both offset patterns and channel chunks of 2 and 11 channels."""
    dp, nvert, hp = plan
    cpu = banded.to_device(hp, "cpu")
    loc = np.random.default_rng(C).standard_normal((dp.nv, C, dp.ncpad))
    for which in ("g", "s"):
        out = banded._scatter(dp, torch.tensor(loc, dtype=dtype, device=dp.base.device),
                              nvert, getattr(dp, which))
        ref = banded.banded_scatter_reference(
            cpu, torch.tensor(loc, dtype=dtype), nvert, getattr(cpu, which))
        assert torch.equal(out.cpu(), ref)


# -- the captured time step (vf_fem_tpu_torch.step_graph) ---------------------------

# tests/port_fixtures.HEADLINE_SMALL (dense, Newton-Schulz refresh) and
# bench.py:411-434 with the refresh cut to 8 steps (btd on bf16 factors)
GRAPH_CONFIGS = {
    "dense-ns": ({"jacobian_update": "once_per_step", "stagnation_ratio": 0.5,
                  "jacobian_refresh_steps": 5, "jacobian_refresh_mode": "ns",
                  "jacobian_full_refresh_windows": 2, "fixed_iterations": 2,
                  "assembly": "banded"}, None, 28),
    "btd": ({"linear_solver": "btd", "btd_store_dtype": "bfloat16",
             "jacobian_refresh_steps": 8, "fixed_iterations": 3,
             "fixed_tail_residual": False, "stagnation_ratio": 0.5,
             "assembly": "banded"}, "rcm", 20),
    "spike": ({"linear_solver": "spike", "spike_partitions": 2,
               "btd_store_dtype": "bfloat16", "jacobian_refresh_steps": 8,
               "fixed_iterations": 3, "fixed_tail_residual": False,
               "stagnation_ratio": 0.5, "assembly": "banded"}, "rcm", 20),
}


def _graph_run(cuda, config, dtype):
    from vf_fem_tpu_torch import step_graph

    params, reorder, n_steps = GRAPH_CONFIGS[config]
    model = port_vf_model("KelvinVoigtWEpithelium", device=cuda, dtype=dtype,
                          reorder=reorder)
    state0, cs, prop = port_inputs(model)
    times = 1e-4 * np.arange(n_steps + 1)
    times[3:] += 2e-6 * np.arange(n_steps - 2)  # dt varies from step 3
    assert step_graph.captures(model, forward.solver_params(params))
    return model, (state0, cs, prop, times, params)


def _same_run(a, b):
    (fa, ta, ia), (fb, tb, ib) = a, b
    return (all(torch.equal(fa[k], fb[k]) and torch.equal(ta[k], tb[k]) for k in fa)
            and all(torch.equal(x, y) for x, y in zip(ia, ib)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("config", list(GRAPH_CONFIGS))
def test_graph_equals_eager(cuda, config, dtype):
    """A fixed-iteration run on the card replays one captured step a step:
    its trajectory, infos and final state equal the eager loop's bit for
    bit (non-uniform dt), and every replay adds the captured step's kernel
    launches and predictors."""
    from vf_fem_tpu_torch import step_graph

    model, args = _graph_run(cuda, config, dtype)
    eager = forward._integrate_eager(model, *args)
    ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
    banded.LAUNCHES.update(dict.fromkeys(banded.LAUNCHES, 0))
    model.solid.predictor_counts.update(carried=0, formed=0)
    graph = forward.integrate_pure(model, *args)
    torch.cuda.synchronize()
    assert _same_run(graph, eager)
    (stats,) = step_graph.graph_stats(model).values()
    n_steps = len(args[3]) - 1
    assert stats["captures"] == 1 and stats["replays"] == n_steps - 1
    assert stats["nodes"] > 0
    solves = int(graph[2].num_iter.sum())
    assert ops.LAUNCHES["newmark"] == n_steps
    if config == "btd":
        assert ops.LAUNCHES["btd_sweep"] == 2 * solves
    if config == "spike":
        assert ops.LAUNCHES["btd_sweep_slabs"] == 2 * solves
    # one predictor formed (the first step's), then one carried a step and
    # one at each refresh window's factorization
    windows = len(list(step_graph.refresh_windows(n_steps, forward.solver_params(args[4]))))
    assert model.solid.predictor_counts == {"carried": n_steps + windows, "formed": 1}


def test_graph_is_cached(cuda):
    """A second run with the same settings, over another number of steps,
    captures nothing and replays every step; new inputs give the eager
    loop's bits."""
    from vf_fem_tpu_torch import step_graph

    model, (state0, cs, prop, times, params) = _graph_run(cuda, "dense-ns", torch.float64)
    forward.integrate_pure(model, state0, cs, prop, times, params)
    cs2 = {k: v * 0.9 for k, v in cs.items()}
    state2 = {k: v + 1e-9 for k, v in state0.items()}
    times2 = times[:-5] + 0.1
    graph = forward.integrate_pure(model, state2, cs2, prop, times2, params)
    (stats,) = step_graph.graph_stats(model).values()
    n_steps = len(times) - 1
    assert stats["captures"] == 1 and stats["replays"] == 2 * n_steps - 6
    assert _same_run(graph, forward._integrate_eager(model, state2, cs2, prop, times2, params))


def test_graph_leaves_the_callers_properties_alone(cuda):
    """Runs A, B, A with properties given as CUDA tensors: the graph reads
    copies, so A's tensors are unchanged after B, and the second A run
    gives the eager A run's bits."""
    model, (state0, cs, _, times, params) = _graph_run(cuda, "dense-ns", torch.float64)
    prop_a = {k: torch.tensor(v, device=cuda) for k, v in model.prop.items()}
    kept = {k: v.clone() for k, v in prop_a.items()}
    prop_b = {k: v.clone() for k, v in prop_a.items()}
    prop_b["emod"] *= 1.2
    forward.integrate_pure(model, state0, cs, prop_a, times, params)
    forward.integrate_pure(model, state0, cs, prop_b, times, params)
    assert all(torch.equal(prop_a[k], kept[k]) for k in kept)
    again = forward.integrate_pure(model, state0, cs, prop_a, times, params)
    assert _same_run(again, forward._integrate_eager(model, state0, cs, kept, times, params))


def test_one_step_run_captures_nothing(cuda):
    """A run of one step has no replay to pay for a capture: it runs the
    step uncaptured, caches no graph and gives the eager loop's bits."""
    from vf_fem_tpu_torch import step_graph

    model, (state0, cs, prop, times, params) = _graph_run(cuda, "btd", torch.float64)
    one = forward.integrate_pure(model, state0, cs, prop, times[:2], params)
    assert step_graph.graph_stats(model) == {}
    assert _same_run(one, forward._integrate_eager(model, state0, cs, prop, times[:2], params))


@pytest.mark.parametrize("params", [{}, {"linear_solver": "bsb", "jacobian_refresh_steps": 4,
                                         "fixed_iterations": 2},
                                    {"fixed_iterations": 2, "jacobian_update": "once_per_step"}])
def test_adaptive_and_per_step_runs_replay_no_graph(cuda, params):
    """Adaptive Newton, the Krylov solvers and per-step factorizations stay
    eager: no graph is captured or replayed."""
    from vf_fem_tpu_torch import step_graph

    model = port_vf_model("KelvinVoigtWEpithelium", device=cuda, reorder="rcm")
    state0, cs, prop = port_inputs(model)
    assert not step_graph.captures(model, forward.solver_params(params))
    forward.integrate_pure(model, state0, cs, prop, 1e-4 * np.arange(6), params)
    assert step_graph.graph_stats(model) == {}


@pytest.mark.parametrize("layout", ["aligned", "view", "mixed"])
@pytest.mark.parametrize("n", [960, 23_754])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_row_from_device_memory(cuda, dtype, n, layout):
    """K5 with its coefficients read from a row of a table on the device
    (in the vectors' dtype): bit for bit the plain version of that row (and
    of the same steps as floats), eagerly and in a CUDA-graph replay that
    reads another row of the table after each replay's counter."""
    from vf_fem_tpu_torch.equations import newmark

    args = _newmark_inputs(n, layout, dtype, cuda)
    steps = [(1e-4, 7.5e-5), (7.5e-5, 1.3e-4), (1.3e-4, 1.3e-4)]
    table = ops.newmark_row([newmark.coefficients(*s) for s in steps], dtype, cuda)
    for i, (dt, dtp) in enumerate(steps):
        outs = ops.newmark_update_coefs(*args, table[i])
        refs = ops.newmark_update_reference(*args, dt, dt_next=dtp)
        assert all(torch.equal(o, r) for o, r in zip(outs, refs))
        assert all(torch.equal(o, r) for o, r in
                   zip(outs, ops.newmark_update_coefs_reference(*args, table[i])))
    counter = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = [torch.empty_like(args[0]) for _ in range(3)]

    def step():
        res = ops.newmark_update_coefs(*args, table.index_select(0, counter)[0])
        for o, r in zip(out, res):
            o.copy_(r)
        counter.add_(1)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for i in (1, 2):
        graph.replay()
        torch.cuda.synchronize()
        refs = ops.newmark_update_reference(*args, steps[i][0], dt_next=steps[i][1])
        assert all(torch.equal(o, r) for o, r in zip(out, refs))


def test_res_u_with_a_coefficient_row_on_cuda(cuda):
    """The residual multiplies by 0-d tensors of a coefficient row and
    gives the Python floats' bits on the card, f64 and f32."""
    from vf_fem_tpu_torch.equations import newmark
    from vf_fem_tpu_torch.models.transient import StepCoefs

    for dtype in (torch.float64, torch.float32):
        model = port_vf_model("KelvinVoigtWEpithelium", device=cuda, dtype=dtype)
        solid = model.solid
        rng = np.random.default_rng(3)
        s0 = {k: torch.tensor(1e-3 * rng.standard_normal(solid.ndof), dtype=dtype,
                              device=cuda) for k in ("u", "v", "a")}
        u1 = s0["u"] + 1e-4
        prop = {k: torch.tensor(model.prop[k], dtype=dtype, device=cuda)
                for k in model._solid_prop_keys}
        ctrl = {"p1": torch.full((solid.nvert,), 500.0, dtype=dtype, device=cuda)}
        for dt in (1e-4, 3.7e-5):
            row = torch.tensor(newmark.coefficients(dt, 2e-4), dtype=torch.float64,
                               device=cuda)
            for banded_ in (True, False):
                assert torch.equal(
                    solid.res_u(u1, s0, ctrl, prop, StepCoefs(row, dtype), banded_),
                    solid.res_u(u1, s0, ctrl, prop, dt, banded_))


def test_capture_with_a_host_sync_raises(cuda):
    """A step that synchronises with the host cannot be captured: the run
    raises, it does not fall back to the eager loop (last in this file: a
    failed capture may leave the process's CUDA state unusable)."""
    from vf_fem_tpu_torch import step_graph

    model, args = _graph_run(cuda, "dense-ns", torch.float64)
    step = model.step_pure_stale

    def synced(*a, **kw):
        state, info = step(*a, **kw)
        float(info.abs_err)  # a device-to-host copy: a sync
        return state, info

    model.step_pure_stale = synced
    with pytest.raises(RuntimeError):
        forward.integrate_pure(model, *args)
    assert step_graph.graph_stats(model) == {}


# -- the gradient path: K5T, K6T and value+grad runs ----------------------------------


@pytest.mark.parametrize("n", [1, 2, "ring-1", "ring+1", 93])
@pytest.mark.parametrize("bt", kernels.SWEEP_T_WIDTHS)
@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_btd_sweep_t_rows_every_width(cuda, pair, bt, n):
    """K6T on random factors scaled to 0.5/sqrt(Bt), both sweeps, at n = 1,
    2, one row block below and above the depth of its ring of column boxes
    (``ops.sweep_t_plan``) and 93: each row within rtol 1e-13 (f64 vectors)
    / 1e-6 (f32) plus the dot-product order bound of the plain row from the
    kernel's own previous row, the same bits in three launches, and one
    launch a call.  (On random factors the order differences of the rows
    compound along the sweep, so the whole sweep is held to the plain one
    only on the model's factors, in ``chip_smoke.py`` phase 3.)"""
    fdt, vdt = SWEEP_PAIRS[pair]
    if isinstance(n, str):
        n = ops.sweep_t_plan(bt, fdt, vdt).ring + (1 if n == "ring+1" else -1)
    _, _, Ad, gd = _random_sweep(pair, bt, n, seed=3 * bt + n, dev=cuda)
    rtol = 1e-13 if gd.dtype == torch.float64 else 1e-6
    n0 = ops.LAUNCHES["btd_sweep_t"]
    for rev in (False, True):
        outs = [ops.btd_sweep_t(Ad, gd, reverse=rev) for _ in range(3)]
        out = outs[0]
        ref, bound = ops.btd_sweep_t_rows_reference(Ad, gd, out, rev)
        assert_scatter_close(out, ref, bound, rtol)
        assert all(torch.equal(out, o) for o in outs[1:])
    assert ops.LAUNCHES["btd_sweep_t"] == n0 + 6


@pytest.mark.parametrize("bt", kernels.SWEEP_T_WIDTHS)
@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_sweep_t_plan_is_the_kernels(cuda, pair, bt):
    """``ops.sweep_t_plan`` (the CPU tests' copy) is K6T's plan compiled into
    ``csrc/btd.cu``."""
    fdt, vdt = SWEEP_PAIRS[pair]
    assert ops.sweep_t_plan(bt, fdt, vdt) == kernels.built_sweep_t_plan(bt, fdt)


@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_btd_sweep_t_matches_plain(large_operator, pair):
    """K6T against its plain version on the 23.7k model's own factors (W
    forward, V backward), row by row as for K6; a transposed btd solve on
    the card is two launches and solves A^T x = r to the factors'
    accuracy."""
    from vf_fem_tpu_torch.solvers import btd

    op, plan, blocks = large_operator
    fdt, vdt = SWEEP_PAIRS[pair]
    fac = _btd_factors(plan, blocks, fdt)
    rng = np.random.default_rng(1)
    g = torch.tensor(rng.standard_normal(tuple(fac.V.shape[:2])), dtype=vdt,
                     device=blocks.device)
    rtol = 1e-13 if vdt == torch.float64 else 1e-6
    for A, rev in ((fac.W, False), (fac.V, True)):
        out = ops.btd_sweep_t(A, g, reverse=rev)
        ref, bound = ops.btd_sweep_t_rows_reference(A, g, out, rev)
        assert_scatter_close(out, ref, bound, rtol)
    n0 = ops.LAUNCHES["btd_sweep_t"]
    r = torch.tensor(rng.standard_normal(plan.ndof), dtype=vdt, device=blocks.device)
    fac_v = fac._replace(d=fac.d.to(vdt))
    x = btd.btd_solve_t(plan, fac_v, r)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["btd_sweep_t"] == n0 + 2
    assert bool(torch.isfinite(x).all())
    if (fdt, vdt) == (torch.float64, torch.float64):
        # the same solve through the plain sweeps on the CPU
        cpu = btd.btd_solve_t(plan, btd.BTDFactors(*(t.cpu() for t in fac_v)), r.cpu())
        torch.testing.assert_close(x.cpu(), cpu, rtol=1e-9, atol=1e-12 * cpu.abs().max())


def test_btd_sweep_t_rejects_bad_input(large_operator):
    _, _, blocks = large_operator
    dev = blocks.device
    A = torch.zeros((3, 256, 256), dtype=torch.bfloat16, device=dev)
    g = torch.zeros((3, 256), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.btd_sweep_t(A.transpose(1, 2), g)
    with pytest.raises(ValueError, match="tensors on"):
        ops.btd_sweep_t(A, g.cpu())
    with pytest.raises(TypeError):
        ops.btd_sweep_t(A.half(), g)
    with pytest.raises(ValueError, match="row blocks"):
        ops.btd_sweep_t(A[:, :16, :16].contiguous(), g[:, :16].contiguous())
    # the ring's bulk copies need 16-byte aligned factors
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.btd_sweep_t(torch.zeros(A.numel() + 1, dtype=A.dtype, device=dev)[1:].view(A.shape), g)


def _newmark_t_check(vecs, row):
    """K5T in three launches against its plain version: the four vector
    cotangents bit for bit, the row's cotangent within the bound on
    summation order (rtol 1e-13 / 1e-6 besides), the same bits in every
    launch, and its entries 6 and 7 zero."""
    n0 = ops.LAUNCHES["newmark_t"]
    outs = [ops.newmark_update_t(*vecs, row) for _ in range(3)]
    refs = ops.newmark_update_t_reference(*vecs, row)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["newmark_t"] == n0 + 3
    for out, ref in zip(outs[0][:4], refs[:4]):
        assert torch.equal(out, ref)
    vb1, ab1, u1, u0, v0, a0 = vecs
    absrow = ops.newmark_update_t_reference(vb1.abs(), ab1.abs(), u1.abs(),
                                            -u0.abs(), -v0.abs(), -a0.abs(),
                                            row.abs())[4].abs()
    bound = ops.dot_order_bound(absrow, u1.numel())
    rtol = 1e-13 if u1.dtype == torch.float64 else 1e-6
    assert_scatter_close(outs[0][4], refs[4], bound, rtol)
    assert all(torch.equal(o[4], outs[0][4]) for o in outs[1:])
    assert not outs[0][4][6:].any()


@pytest.mark.parametrize("n", [960, 23_754, 123, 94_810, 1, 7])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_t_matches_plain(cuda, dtype, n):
    """K5T against its plain version (``_newmark_t_check``) on separate
    vectors, on views that start one entry off the 16-byte alignment (the
    wrapper allocates the outputs in u1's phase: 16-byte vectors after a
    scalar head) and on views in mixed phases (the scalar loop)."""
    from vf_fem_tpu_torch.equations import newmark

    rng = np.random.default_rng(n)
    row = ops.newmark_row(newmark.coefficients(1e-4, 0.75e-4), dtype, cuda)
    full = [torch.tensor(rng.standard_normal(n + 3), dtype=dtype, device=cuda)
            for _ in range(6)]
    _newmark_t_check([f[:n].clone() for f in full], row)
    _newmark_t_check([f[1:n + 1] for f in full], row)
    _newmark_t_check([f[k:n + k] for f, k in zip(full, (1, 2, 3, 0, 1, 2))], row)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_t_graph_replays(cuda, dtype):
    """K5T captured in a CUDA graph and replayed 200 times, a new row
    written in place between replays: the row's cotangent has the bits of
    an eager launch on that row, the vector cotangents those of the plain
    version."""
    from vf_fem_tpu_torch.equations import newmark

    rng = np.random.default_rng(3)
    vecs = [torch.tensor(rng.standard_normal(23_754), dtype=dtype, device=cuda)
            for _ in range(6)]
    rows = ops.newmark_row([newmark.coefficients(1e-4 * (1 + 0.01 * i), 0.75e-4)
                            for i in range(200)], dtype, cuda)
    row = rows[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.newmark_update_t(*vecs, row)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.newmark_update_t(*vecs, row)
    for i in range(200):
        row.copy_(rows[i])
        graph.replay()
        eager = ops.newmark_update_t(*vecs, rows[i])
        refs = ops.newmark_update_t_reference(*vecs, rows[i])
        torch.cuda.synchronize()
        assert torch.equal(captured[4], eager[4]), i
        assert all(torch.equal(c, r) for c, r in zip(captured[:4], refs[:4])), i


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_t_graphs_on_two_streams(cuda, dtype):
    """Two CUDA graphs of 20 K5T launches each, both captured on PyTorch's
    one capture stream, replayed 50 times at once on two other streams,
    new rows written into each graph's inputs on its stream before each
    replay: every launch's row cotangent has the bits of an eager launch on
    its row.  Each capture has its own slots (counter and partial sums), so
    the two graphs never share one however their launches interleave."""
    from vf_fem_tpu_torch.equations import newmark

    rng = np.random.default_rng(6)
    vecs = [torch.tensor(rng.standard_normal(94_810), dtype=dtype, device=cuda)
            for _ in range(6)]
    launches, replays = 20, 50
    table = ops.newmark_row([newmark.coefficients(1e-4 * (1 + 1e-3 * i), 0.75e-4)
                             for i in range(replays * 2 * launches)], dtype, cuda)
    table = table.view(replays, 2, launches, -1)
    rows = [table[0, g].clone() for g in range(2)]
    ops.newmark_update_t(*vecs, rows[0][0])
    torch.cuda.synchronize()
    graphs, sinks = [], []
    for g in range(2):
        graph, sink = torch.cuda.CUDAGraph(), torch.empty_like(rows[g])
        with torch.cuda.graph(graph):
            for k in range(launches):
                sink[k].copy_(ops.newmark_update_t(*vecs, rows[g][k])[4])
        graphs.append(graph)
        sinks.append(sink)
    record = torch.empty_like(table)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for r in range(replays):
        for g, st in enumerate(streams):
            with torch.cuda.stream(st):
                rows[g].copy_(table[r, g])
                graphs[g].replay()
                record[r, g].copy_(sinks[g])
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    eager = torch.stack([ops.newmark_update_t(*vecs, row)[4] for row in table.view(-1, 8)])
    torch.cuda.synchronize()
    off = (record.view(-1, 8) != eager).any(dim=1)
    assert not off.any(), f"{int(off.sum())} of {off.numel()} captured launches differ"


def test_newmark_t_one_kernel_a_call(cuda):
    """Ten calls of K5T are ten device kernels in the profiler's trace,
    all of them K5T's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vf_fem_tpu_torch.equations import newmark

    rng = np.random.default_rng(4)
    vecs = [torch.tensor(rng.standard_normal(23_754), device=cuda) for _ in range(6)]
    row = ops.newmark_row(newmark.coefficients(1e-4, 0.75e-4), torch.float64, cuda)
    ops.newmark_update_t(*vecs, row)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.newmark_update_t(*vecs, row)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert sum(c for _, c in kernels) == 10, kernels
    assert all("newmark_t_kernel" in k for k, _ in kernels), kernels


def test_newmark_t_rejects_bad_input(cuda):
    """K5T's wrapper raises on what the kernel does not take."""
    from vf_fem_tpu_torch.equations import newmark

    vecs = [torch.zeros(8, dtype=torch.float64, device=cuda) for _ in range(6)]
    row = ops.newmark_row(newmark.coefficients(1e-4), torch.float64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.newmark_update_t(*vecs[:5], torch.zeros(16, dtype=torch.float64,
                                                     device=cuda)[::2], row)
    with pytest.raises(TypeError, match="mixed dtypes"):
        ops.newmark_update_t(*vecs[:5], vecs[5].float(), row)
    with pytest.raises(ValueError, match="tensors on"):
        ops.newmark_update_t(*vecs[:5], vecs[5].cpu(), row)
    with pytest.raises(ValueError, match="one shape"):
        ops.newmark_update_t(*vecs[:5], vecs[5][:4], row)
    with pytest.raises(ValueError, match="coefficients"):
        ops.newmark_update_t(*vecs, row.float())
    with pytest.raises(ValueError, match="empty"):
        ops.newmark_update_t(*(v[:0] for v in vecs), row)


def _grad_model(cuda_or_cpu, config):
    params, reorder, solid = GRAD_CONFIGS[config]
    model = port_vf_model(solid, nx=8 if reorder is None else 10,
                          ny=4 if reorder is None else 5, device=cuda_or_cpu,
                          reorder=reorder)
    return model, params


# small value+grad runs: the M5 adjoint settings of benchmark_adjoint.py:79-88
# scaled down, and the production adjoint's (bf16 btd factors, refresh 4)
GRAD_CONFIGS = {
    "dense": ({"jacobian_update": "once_per_step", "stagnation_ratio": 0.5,
               "jacobian_refresh_steps": 4, "jacobian_refresh_mode": "ns",
               "jacobian_full_refresh_windows": 4}, None, "KelvinVoigtWEpithelium"),
    "btd": ({"linear_solver": "btd", "btd_store_dtype": "bfloat16",
             "jacobian_refresh_steps": 4, "stagnation_ratio": 0.5}, "rcm",
            "KelvinVoigtWEpithelium"),
}


def _loss(traj, controls, prop, times):
    return torch.sum(traj["q"][-4:] ** 2) * 1e-6 + torch.sum(traj["u"][-1] ** 2) * 1e4


@pytest.mark.parametrize("config", list(GRAD_CONFIGS))
def test_value_and_grad_on_cuda_match_cpu(cuda, config):
    """A small value+grad run (``adjoint.integrate_grad``) on the card
    against the same run on the CPU: the values within 1e-10, every
    gradient group per key within 1e-6 of its largest entry (the card sums
    in other orders: cuBLAS, K6/K6T, the bf16 factors' f32 sums, and
    the refined adjoint stops on its residual; adaptive Newton, so the
    trajectories agree to its tolerance).  The value equals the
    card's no-grad forward bit for bit; the run launches K5T (one a step
    whose v1, a1 reach the loss) and, with btd factors, K6T; no step graph
    is replayed."""
    from vf_fem_tpu_torch import adjoint, step_graph

    times = 2e-5 * np.arange(9)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model, params = _grad_model(dev, config)
        state0, cs, prop = port_inputs(model)
        ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
        value, grads = adjoint.integrate_grad(model, _loss, state0, [model.control],
                                              prop, times, params)
        runs[dev.type] = (value, grads, dict(ops.LAUNCHES), model, params)
    (vc, gc, lc, mc, params), (vh, gh, lh, _, _) = runs["cuda"], runs["cpu"]
    assert abs(vc - vh) <= 1e-10 * abs(vh)
    for group in ("ini_state", "controls", "prop"):
        for k in gh[group]:
            scale = np.abs(gh[group][k]).max()
            assert np.isfinite(gc[group][k]).all()
            assert np.abs(gc[group][k] - gh[group][k]).max() <= 1e-6 * scale, (group, k)
    np.testing.assert_allclose(gc["times"], gh["times"], rtol=1e-6,
                               atol=1e-6 * np.abs(gh["times"]).max())
    # K5T runs in every step's backward but the last's, whose v1 and a1 do
    # not reach the loss
    assert lc["newmark_t"] == len(times) - 2 and lh["newmark_t"] == 0
    if config == "btd":
        assert lc["btd_sweep_t"] > 0
    assert not step_graph.graph_stats(mc)
    state0, cs, prop = port_inputs(mc)
    _, traj, _ = forward.integrate_pure(mc, state0, cs, prop, times, params)
    assert float(_loss(traj, None, None, None)) == vc


def test_backward_raises_no_version_error_on_cuda(cuda):
    """The value+grad run of a fixed-iteration stale-factor btd run (which a
    no-grad run replays as a captured graph) raises no version-counter
    error in backward: nothing the graph saves is written in place."""
    from vf_fem_tpu_torch import adjoint

    model, params = _grad_model(cuda, "btd")
    params = {**params, "fixed_iterations": 3, "fixed_tail_residual": False}
    state0, cs, prop = port_inputs(model)
    times = 2e-5 * np.arange(9)
    forward.integrate_pure(model, state0, cs, prop, times, params)  # a graph run first
    value, grads = adjoint.integrate_grad(model, _loss, state0, [model.control], prop,
                                          times, params)
    assert np.isfinite(value) and all(np.isfinite(v).all() for v in grads["prop"].values())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_transposed_ops_match_plain(large_f64, large_operator, dtype):
    """K3T (cells and facets) and K4T against their plain versions at the
    23.7k shapes: rtol 1e-13 (f64) / 1e-6 (f32) per entry plus the bound on
    summation-order differences (``ops.dot_order_bound``); K4T bit for bit
    its CPU emulation and the same bits in 3 launches; one launch a call."""
    op, plan, blocks64 = large_operator
    fill = large_f64.solid.bsb_plan()[1]
    dev = blocks64.device
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    x = torch.tensor(np.random.default_rng(8).standard_normal(plan.ndof), dtype=dtype,
                     device=dev)
    n0 = dict(ops.LAUNCHES)
    for J, d in ((op.J_cells, op.cell_dofs), (op.J_facets, op.facet_dofs)):
        J = J.to(dtype)
        y, ref = ops.ebe_matvec_t(J, x, d), ops.ebe_matvec_t_reference(J, x, d)
        bound = ops.dot_order_bound(ops.ebe_matvec_t_reference(J.abs(), x.abs(), d), 6)
        assert bool(((y - ref).abs() <= rtol * ref.abs() + bound).all())
    blocks = blocks64.to(dtype)
    ys = [ops.bsb_matvec_t(plan, blocks, x, fill.pattern_t) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    ref = ops.bsb_matvec_t_reference(plan, blocks, x)
    bound = ops.dot_order_bound(ops.bsb_matvec_t_reference(plan, blocks.abs(), x.abs()),
                                plan.nb * plan.b)
    assert bool(((ys[0] - ref).abs() <= rtol * ref.abs() + bound).all())
    host_t = type(fill.pattern_t)(*(a.cpu().numpy() for a in fill.pattern_t))
    emul = emulate_bsb_matvec_t(plan, host_t, blocks.cpu().numpy(), x.cpu().numpy(),
                                kernels.BSB_LANES)
    assert np.array_equal(ys[0].cpu().numpy(), emul)
    assert ops.LAUNCHES["ebe_matvec_t"] == n0["ebe_matvec_t"] + 2
    assert ops.LAUNCHES["bsb_matvec_t"] == n0["bsb_matvec_t"] + 3


@pytest.mark.parametrize("fill", ["random 23.7k", "small"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bsb_matvec_t_is_its_emulation(large_f64, large_operator, fill, dtype):
    """K4T bit for bit its CPU emulation (``emulate_bsb_matvec_t``), the same
    bits in three launches and one launch a call, on a fill from random
    element Jacobians at 23.7k and on the 10 x 5 RCM model's plan, whose
    132 dofs leave a ragged CTA of 4 columns and a window that starts
    before row 0 and ends past the last."""
    if fill == "small":
        model = port_vf_model("KelvinVoigtWEpithelium", 10, 5, device=large_f64.solid.device,
                              reorder="rcm")
        plan, bfill = model.solid.bsb_plan()
        assert plan.ndof % 64
    else:
        plan, bfill = large_f64.solid.bsb_plan()
    dev = large_operator[2].device
    rng = np.random.default_rng(9)
    src = torch.tensor(rng.standard_normal(plan.tgt_idx.size), device=dev)
    B = bsb.bsb_fill(plan, bfill, [src]).to(dtype)
    x = torch.tensor(rng.standard_normal(plan.ndof), dtype=dtype, device=dev)
    n0 = ops.LAUNCHES["bsb_matvec_t"]
    ys = [ops.bsb_matvec_t(plan, B, x, bfill.pattern_t) for _ in range(3)]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bsb_matvec_t"] == n0 + 3
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    host_t = type(bfill.pattern_t)(*(a.cpu().numpy() for a in bfill.pattern_t))
    emul = emulate_bsb_matvec_t(plan, host_t, B.cpu().numpy(), x.cpu().numpy(),
                                kernels.BSB_LANES)
    assert np.array_equal(ys[0].cpu().numpy(), emul)


def test_bsb_matvec_t_rejects_bad_input(large_f64, large_operator):
    op, plan, blocks = large_operator
    fill = large_f64.solid.bsb_plan()[1]
    x = torch.zeros(plan.ndof, dtype=torch.float64, device=blocks.device)
    n0 = ops.LAUNCHES["bsb_matvec_t"]
    # K4T has no dense-band fallback: without its pattern it raises
    with pytest.raises(ValueError, match="pattern_t"):
        ops.bsb_matvec_t(plan, blocks, x)
    with pytest.raises(ValueError, match="pattern.ptr"):
        ops.bsb_matvec_t(plan, blocks, x,
                         fill.pattern_t._replace(ptr=fill.pattern_t.ptr[1:]))
    with pytest.raises(ValueError, match="tensors on"):
        ops.bsb_matvec_t(plan, blocks, x.cpu(), fill.pattern_t)
    # the bulk copy of x's window needs a 16-byte aligned x
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.bsb_matvec_t(plan, blocks, torch.zeros(plan.ndof + 1, dtype=x.dtype,
                                                   device=x.device)[1:], fill.pattern_t)
    assert ops.LAUNCHES["bsb_matvec_t"] == n0
    with pytest.raises(TypeError):
        ops.ebe_matvec_t(op.J_cells.float(), x, op.cell_dofs)


@pytest.mark.parametrize("solver", ["cg", "bsb"])
def test_krylov_value_and_grad_on_cuda_match_cpu(cuda, solver):
    """A small 'cg' / 'bsb' value+grad run (Krylov tolerance 1e-12, a
    transposed BiCGStab solve each step) on the card against the same run
    on the CPU: the values within 1e-10, every gradient key within 1e-6 of
    its largest entry; the card's run launches K3T / K4T, not the other."""
    from vf_fem_tpu_torch import adjoint

    params = {"linear_solver": solver, "krylov_tolerance": 1e-12,
              "jacobian_refresh_steps": 1}
    times = 2e-5 * np.arange(7)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model = port_vf_model("KelvinVoigtWEpithelium", 10, 5, device=dev, reorder="rcm")
        state0, _, prop = port_inputs(model)
        ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
        runs[dev.type] = (*adjoint.integrate_grad(model, _loss, state0, [model.control],
                                                  prop, times, params), dict(ops.LAUNCHES))
    (vc, gc, lc), (vh, gh, lh) = runs["cuda"], runs["cpu"]
    assert abs(vc - vh) <= 1e-10 * abs(vh)
    for group in ("ini_state", "controls", "prop"):
        for k in gh[group]:
            scale = np.abs(gh[group][k]).max()
            assert np.abs(gc[group][k] - gh[group][k]).max() <= 1e-6 * scale, (group, k)
    mine, other = (("ebe_matvec_t", "bsb_matvec_t") if solver == "cg"
                   else ("bsb_matvec_t", "ebe_matvec_t"))
    assert lc[mine] > 0 and lc[other] == 0 and lh[mine] == 0


def test_integrate_linear_on_cuda_matches_cpu(cuda):
    """``forward.integrate_linear_pure`` on a CUDA model (bf16 btd factors,
    refresh 1) dispatches K1, K2, K5 (three launches a step: the update and
    its tangent's two) and K6, and its tangent meets the CPU model's within
    1e-8 of each field's largest entry."""
    times = 2e-5 * np.arange(6)
    params = {"linear_solver": "btd", "btd_store_dtype": "bfloat16",
              "jacobian_refresh_steps": 1, "assembly": "banded"}
    rng = np.random.default_rng(12)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = port_vf_model("KelvinVoigtWEpithelium", 10, 5, device=dev, reorder="rcm")
        s0, cs, prop = port_inputs(model)
        if not out:
            dprop = {k: np.zeros_like(v) for k, v in prop.items()}
            dprop["emod"] = 100.0 * rng.standard_normal(prop["emod"].shape)
            dcs = {k: rng.standard_normal(v.shape) for k, v in cs.items()}
        ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
        banded.LAUNCHES.update(dict.fromkeys(banded.LAUNCHES, 0))
        _, dfin = forward.integrate_linear_pure(
            model, s0, cs, prop, times, {k: np.zeros_like(v) for k, v in s0.items()}, dcs,
            dprop, np.zeros_like(times), params)
        out[dev.type] = ({k: v.cpu().numpy() for k, v in dfin.items()},
                         {**ops.LAUNCHES, **banded.LAUNCHES})
    (dc, lc), (dh, lh) = out["cuda"], out["cpu"]
    n_steps = len(times) - 1
    assert lc["gather"] > 0 and lc["scatter"] > 0 and lc["btd_sweep"] > 0
    assert lc["newmark"] == 3 * n_steps
    assert not any(lh.values())
    for k, v in dh.items():
        np.testing.assert_allclose(dc[k], v, rtol=1e-8, atol=1e-8 * np.abs(v).max(), err_msg=k)


def test_traction_shape_on_cuda_matches_cpu(cuda):
    """The banded ``TractionShape`` on the card (K6 / K6T solves, K1/K2 in
    ``T t`` and ``T^T lam``) against the same transform on the CPU: apply
    and apply_vjp within 1e-10 of their largest entries."""
    from vf_fem_tpu_torch.load import load_solid_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.parameters import TractionShape
    from vf_fem_tpu_torch.residuals import solid as slr

    rng = np.random.default_rng(13)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        solid = load_solid_model(vocal_fold_mesh(10, 5), slr.KelvinVoigtWShape, device=dev,
                                 reorder="rcm")
        t = TractionShape(solid, solver="banded")
        if not res:
            x = {"tmesh": 1e2 * rng.standard_normal(solid.ndof)}
            hy = {"umesh": rng.standard_normal(solid.ndof)}
        ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
        res[dev.type] = (t.apply(x)["umesh"], t.apply_vjp(x, hy)["tmesh"], dict(ops.LAUNCHES))
    (uc, gc, lc), (uh, gh, _) = res["cuda"], res["cpu"]
    assert lc["btd_sweep"] > 0 and lc["btd_sweep_t"] > 0
    np.testing.assert_allclose(uc, uh, rtol=1e-10, atol=1e-10 * np.abs(uh).max())
    np.testing.assert_allclose(gc, gh, rtol=1e-10, atol=1e-10 * np.abs(gh).max())


def test_traction_shape_default_solver_stays_on_cuda(cuda):
    """``TractionShape(solver='auto')`` on a card model at M5 size (960
    dofs, below ``dense_max_dofs``) takes the banded path: its solves are
    K6/K6T launches on the card, and its results match the dense host path
    of the same transform on the CPU within 1e-9 of their largest entries."""
    from vf_fem_tpu_torch.load import load_solid_model
    from vf_fem_tpu_torch.parameters import TractionShape
    from vf_fem_tpu_torch.residuals import solid as slr

    mesh = load_gmsh(os.path.join(MESHES, "M5_3layers.msh"))
    rng = np.random.default_rng(17)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        solid = load_solid_model(mesh, slr.KelvinVoigtWShape, device=dev, reorder="rcm")
        t = TractionShape(solid)
        if not res:
            assert solid.ndof <= 6000
            x = {"tmesh": 1e2 * rng.standard_normal(solid.ndof)}
            hy = {"umesh": rng.standard_normal(solid.ndof)}
        ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
        res[dev.type] = (t._solver, t.apply(x)["umesh"], t.apply_vjp(x, hy)["tmesh"],
                         dict(ops.LAUNCHES))
    (sc, uc, gc, lc), (sh, uh, gh, _) = res["cuda"], res["cpu"]
    assert (sc, sh) == ("banded", "dense")
    assert lc["btd_sweep"] > 0 and lc["btd_sweep_t"] > 0
    np.testing.assert_allclose(uc, uh, rtol=1e-9, atol=1e-9 * np.abs(uh).max())
    np.testing.assert_allclose(gc, gh, rtol=1e-9, atol=1e-9 * np.abs(gh).max())


# -- implicit coupling and the static solvers -----------------------------------


def test_implicit_golden_on_cuda(cuda):
    """``golden_fsi_implicit.npz`` (KelvinVoigt + BernoulliSmoothMinSep,
    8 x 4, Picard coupling) in f64 on the card, through K1/K2 and K5, at
    the golden's rtol 1e-8."""
    data = np.load(os.path.join(os.path.dirname(__file__), "data", "golden_fsi_implicit.npz"))
    model = port_vf_model("KelvinVoigt", 8, 4, device=cuda, fluid="BernoulliSmoothMinSep",
                          coupling="implicit")
    before = {**banded.LAUNCHES, **ops.LAUNCHES}
    _, traj, _ = forward.integrate_pure(model, *port_inputs(model), data["times"])
    torch.cuda.synchronize()
    after = {**banded.LAUNCHES, **ops.LAUNCHES}
    assert all(after[k] > before[k] for k in ("gather", "scatter", "newmark"))
    np.testing.assert_allclose(traj["u"].cpu().numpy()[::6], data["u"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(traj["q"].cpu().numpy().ravel(), data["q"], rtol=1e-8)


def test_static_btd_on_cuda(cuda):
    """The static solve on block-Thomas factors ('btd') on the card against
    the CPU port, within 1e-9 of max|u|: K6 launched by the solve, K6T by
    its backward, whose gradients match the CPU's within 1e-9 of their
    largest entry."""
    rng = np.random.default_rng(12)
    results = {}
    for dev in ("cpu", cuda):
        model = port_vf_model("KelvinVoigt", 10, 5, device=dev, reorder="rcm",
                              fluid="BernoulliSmoothMinSep")
        s = model.solid
        p1 = torch.as_tensor(rng.uniform(0.0, 500.0, s.nvert) if dev == "cpu"
                             else results["cpu"][3], device=dev).requires_grad_()
        prop = {k: torch.as_tensor(model.prop[k], device=dev).requires_grad_(k == "emod")
                for k in s.prop}
        n0 = dict(ops.LAUNCHES)
        u1, _ = s.solve_static_u1(torch.zeros(s.ndof, dtype=torch.float64, device=dev),
                                  {"p1": p1}, prop, {"linear_solver": "btd"})
        n1 = dict(ops.LAUNCHES)
        g = torch.autograd.grad(u1, (p1, prop["emod"]), torch.ones_like(u1))
        n2 = dict(ops.LAUNCHES)
        results[str(dev)] = (u1.detach().cpu().numpy(), [x.cpu().numpy() for x in g],
                             (n1, n2, n0), p1.detach().cpu().numpy())
    u_cpu, g_cpu, _, _ = results["cpu"]
    u_gpu, g_gpu, (n1, n2, n0), _ = results["cuda"]
    assert n1["btd_sweep"] > n0["btd_sweep"]
    assert n2["btd_sweep_t"] > n1["btd_sweep_t"]
    assert np.abs(u_gpu - u_cpu).max() <= 1e-9 * np.abs(u_cpu).max()
    for a, b in zip(g_gpu, g_cpu):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()


# -- fluid-solid-acoustic coupling -------------------------------------------------


def test_fsai_graph_equals_eager(cuda):
    """The M5 FSAI model of ``golden_m5_fsai.npz`` on the card with the M5
    headline's settings: the step (solid, flow root solve, tract) is
    captured once and replayed, its trajectory (``pinc``/``pref``
    included), infos (``bracketed`` included) and final state equal the
    eager loop's bit for bit, no step falls back to the lagged exchange,
    and the stored displacements of the first 40 steps are the golden's
    (rtol 1e-8)."""
    import json

    from port_fixtures import port_m5_fsai_model
    from vf_fem_tpu_torch import step_graph

    gold = np.load(os.path.join(os.path.dirname(__file__), "data", "golden_m5_fsai.npz"))
    config = json.loads(str(gold["config"]))
    model = port_m5_fsai_model(config, device=cuda)
    params = {**config["params"], "assembly": "banded"}
    assert step_graph.captures(model, forward.solver_params(params))
    n_steps = 40
    args = (*port_inputs(model), gold["times"][:n_steps + 1], params)
    eager = forward._integrate_eager(model, *args)
    graph = forward.integrate_pure(model, *args)
    torch.cuda.synchronize()
    assert _same_run(graph, eager)
    (stats,) = step_graph.graph_stats(model).values()
    assert stats["captures"] == 1 and stats["replays"] == n_steps - 1
    assert bool(graph[2].bracketed.all())
    every = int(gold["steps"][0])
    np.testing.assert_allclose(graph[1]["u"].cpu().numpy()[every - 1 :: every],
                               gold["u"][: n_steps // every], rtol=1e-8, atol=1e-12)


# -- slice 6: the complex block-Thomas solve and the Hopf analysis -------------


@pytest.mark.parametrize("factor_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("h, nblk, ndof", [(1, 4, 4 * 128 - 37), (2, 5, 5 * 128 - 11)])
def test_cbtd_solve_on_cuda_matches_cpu(cuda, h, nblk, ndof, factor_dtype):
    """``cbtd_solve`` on the card (two K6 launches at 2Bt = 256 or 512, the
    second with a pad super-block) against the same system solved on the
    CPU (K6's plain version): factored in f64, the factors stored in
    ``factor_dtype`` as ``misc.hopf`` stores them; rtol 1e-12 of the
    solution's largest entry in f64, 1e-5 in f32."""
    from vf_fem_tpu_torch.solvers import cbtd

    from port_fixtures import bare_plan, complex_band_system

    blocks, A, r = complex_band_system(h, nblk, ndof, seed=11 + h)
    plan = bare_plan(bsb.BSBPlan, h, nblk, ndof)
    xs = {}
    for dev in (torch.device("cpu"), cuda):
        fac = cbtd.cbtd_factor(plan, torch.tensor(blocks.real, device=dev),
                               torch.tensor(blocks.imag, device=dev))
        fac = fac._replace(Sinv=fac.Sinv.to(factor_dtype), V=fac.V.to(factor_dtype),
                           W=fac.W.to(factor_dtype), d=fac.d.to(factor_dtype))
        n0 = ops.LAUNCHES["btd_sweep"]
        xr, xi = cbtd.cbtd_solve(plan, fac, torch.tensor(r.real, device=dev).to(factor_dtype),
                                 torch.tensor(r.imag, device=dev).to(factor_dtype))
        assert ops.LAUNCHES["btd_sweep"] - n0 == (2 if dev.type == "cuda" else 0)
        xs[dev.type] = (xr.cpu().double() + 1j * xi.cpu().double()).numpy()
    rtol = 1e-12 if factor_dtype == torch.float64 else 1e-5
    scale = np.abs(xs["cpu"]).max()
    np.testing.assert_allclose(xs["cuda"], xs["cpu"], rtol=0, atol=rtol * scale)
    x = np.linalg.solve(A, r)
    np.testing.assert_allclose(xs["cuda"], x, rtol=0,
                               atol=(1e-10 if factor_dtype == torch.float64 else 1e-4)
                               * np.abs(x).max())


def test_cbtd_width_without_kernel_raises_on_cuda(cuda):
    """A band of h = 3 blocks embeds at 2Bt = 768, a width K6 lacks."""
    from vf_fem_tpu_torch.solvers import cbtd

    from port_fixtures import bare_plan

    plan = bare_plan(bsb.BSBPlan, 3, 4, 4 * 128)
    blocks = torch.zeros((4, 7, 128, 128), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="2\\*h\\*b = 768"):
        cbtd.cbtd_factor(plan, blocks, blocks)
    with pytest.raises(ValueError, match="kernel built for row blocks"):
        ops.btd_sweep(torch.zeros((2, 768, 768), dtype=torch.float64, device=cuda),
                      torch.zeros((2, 768), dtype=torch.float64, device=cuda))


def _hopf_models(dev):
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    mesh = rcm_mesh(vocal_fold_mesh(8, 4))
    ymax = mesh.coords[:, 1].max()
    out = []
    for model_type in ("transient", "dynamical"):
        m = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                           model_type=model_type, device=dev)
        for k, v in dict(emod=3e4, rho=1.0, eta=2.0, ycontact=ymax + 0.05, kcontact=1e8,
                         rho_air=1.1225e-3, zeta_min=1e-3, zeta_sep=1e-3,
                         ymid=ymax + 0.01).items():
            m.prop[k][:] = v
        out.append(m)
    return out


@pytest.mark.parametrize("factor_dtype", ["float64", "float32"])
def test_hopf_banded_on_cuda_matches_cpu(cuda, factor_dtype):
    """The banded Hopf solver of ``tests/test_hopf.py:147-173``'s models on
    the card (K4 for every band product, K6 for every solve, never a plain
    version) against the same run on the CPU: each mode within 1e-7
    max(|lambda|, 1) (f64 factors) or 1e-6 (f32) of a CPU mode.  The Ritz
    filter accepts a relative residual of 1e-6, so two runs in different
    arithmetic agree to about that backward error, not to rounding."""
    import warnings

    from vf_fem_tpu_torch.misc.hopf import linear_stability

    c = {"psub": np.array([8000.0]), "psup": np.array([0.0])}
    res = {}
    for dev in ("cpu", cuda):
        tm, dm = _hopf_models(dev)
        launches = dict(ops.LAUNCHES)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res[str(dev)] = linear_stability(
                tm, dm, c, tm.prop, solver="banded", sigma=1j * 2 * np.pi * 130.0,
                arnoldi_m=60, return_info=True, factor_dtype=factor_dtype)
        if dev == cuda:
            n4 = ops.LAUNCHES["bsb_matvec"] - launches["bsb_matvec"]
            n6 = ops.LAUNCHES["btd_sweep"] - launches["btd_sweep"]
            assert n4 > 0 and n6 > 0, (n4, n6)
    (e_cpu, _, i_cpu), (e_gpu, _, i_gpu) = res["cpu"], res[str(cuda)]
    assert i_gpu["device"].startswith("cuda") and i_gpu["factor_dtype"] == factor_dtype
    assert len(e_gpu) == len(e_cpu) and np.all(i_gpu["res_rel"] < i_gpu["cert_tol"])
    tol = 1e-7 if factor_dtype == "float64" else 1e-6
    for lam in e_gpu:
        assert np.abs(e_cpu - lam).min() < tol * max(abs(lam), 1.0), (lam, e_cpu)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_swelling_banded_cell_pass_matches_plain(cuda, dtype):
    """SwellingKelvinVoigtWEpithelium's residual with its cell pass through
    K1/K2 (the banded path: the nonlinear Green-Lagrange element kernel on
    the gathered locals) against its plain indexed pass on the card, on
    M5-3layers with random fields (swelling volumes about 1): one launch
    of each kernel, and the two within summation order (rtol 1e-12 and
    atol 1e-14 of the largest entry in f64, 1e-5 and 1e-6 in f32)."""
    from vf_fem_tpu_torch.residuals import solid as slr

    mesh = load_gmsh(os.path.join(MESHES, "M5_3layers.msh"))
    R = slr.SwellingKelvinVoigtWEpithelium(mesh, device=cuda, dtype=dtype)
    rng = np.random.default_rng(7)
    values = {"prop/emod": (1e4, 1e5), "prop/rho": (0.5, 1.5), "prop/eta": (1.0, 5.0),
              "prop/v_swelling": (0.95, 1.05), "prop/m_swelling": (-1.0, 1.0),
              "prop/emod_membrane": (1e4, 1e5), "prop/nu_membrane": (0.2, 0.45),
              "prop/th_membrane": (0.0, 0.05), "prop/nu": (0.45, 0.45),
              "prop/ycontact": (0.6, 0.6), "prop/kcontact": (1e8, 1e8)}
    fields = {}
    for key in R.coefficient_spec:
        shape = R.coefficient_shape(key)
        if key in values:
            arr = rng.uniform(*values[key], shape)
        elif key == "prop/ncontact":
            arr = np.array([0.0, 1.0])
        elif key == "control/p1":
            arr = 1e3 * rng.random(shape)
        else:  # states and the contact traction
            arr = 1e-2 * rng.standard_normal(shape)
        fields[key] = torch.as_tensor(arr, dtype=dtype, device=cuda)
    assert R.banded_ok()
    n0 = dict(banded.LAUNCHES)
    out = R.assemble_res(fields, banded=True)
    torch.cuda.synchronize()
    assert banded.LAUNCHES["gather"] == n0["gather"] + 1
    assert banded.LAUNCHES["scatter"] == n0["scatter"] + 1
    ref = R.assemble_res(fields, banded=False)
    rtol, atol = (1e-12, 1e-14) if dtype == torch.float64 else (1e-5, 1e-6)
    scale = float(ref.abs().max())
    assert scale > 0 and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("solid, fluid", [
    ("SwellingKelvinVoigtWEpithelium", "BernoulliFixedSep"),
    ("Rayleigh", "BernoulliFlowFixedSep"),
])
def test_fixed_sep_graph_equals_eager(cuda, solid, fluid):
    """The fixed-separation fluids hold their separation mask on the device:
    a fixed-iteration run of the M5 physics models (``chip_smoke.py``'s
    phase 15 configuration) captures its step and replays it bit for bit
    the eager loop's, with K1, K2 and K5 launched."""
    import chip_smoke as cs

    built, _ = cs.physics_model(torch, cuda, "M5_3layers.msh", torch.float64, solid, fluid)
    model, state0, controls, prop = built
    times = cs.DT * np.arange(31)
    eager = forward._integrate_eager(model, state0, controls, prop, times, cs.HEADLINE)
    banded.LAUNCHES.update(dict.fromkeys(banded.LAUNCHES, 0))
    ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))
    graph = forward.integrate_pure(model, state0, controls, prop, times, cs.HEADLINE)
    torch.cuda.synchronize()
    assert _same_run(graph, eager)
    assert banded.LAUNCHES["gather"] > 0 and banded.LAUNCHES["scatter"] > 0
    assert ops.LAUNCHES["newmark"] == 30


def _reset_launches():
    banded.LAUNCHES.update(dict.fromkeys(banded.LAUNCHES, 0))
    ops.LAUNCHES.update(dict.fromkeys(ops.LAUNCHES, 0))


@pytest.mark.parametrize("options", [None, {"fixed_iterations": 2,
                                            "jacobian_update": "once_per_step"}])
def test_solve_state1_matches_step_pure_on_cuda(cuda, options):
    """The stateful ``solve_state1`` is the model's step function on the
    card: from the same state (5 steps off rest), control, properties and
    dt it gives ``step_pure``'s state bit for bit and the same Newton
    count, with K1, K2 and K5 launched."""
    import chip_smoke as cs
    from vf_fem_tpu_torch.convert import to_tensors

    model, state0, controls, prop = cs.build(torch, cuda, "M5_CB_GA3.msh", torch.float64)
    _, traj, _ = forward.integrate_pure(model, state0, controls, prop, cs.DT * np.arange(6))
    state = {k: v[-1].cpu().numpy() for k, v in traj.items()}
    control = {k: v[0] for k, v in controls.items()}
    model.set_ini_state(state)
    model.set_control(control)
    model.set_prop(prop)
    model.dt = cs.DT
    _reset_launches()
    out, info = model.solve_state1(model.state0, options)
    torch.cuda.synchronize()
    assert banded.LAUNCHES["gather"] > 0 and banded.LAUNCHES["scatter"] > 0
    assert ops.LAUNCHES["newmark"] == 1
    args = [to_tensors(d, cuda, torch.float64) for d in (state, control, prop)]
    with torch.no_grad():
        ref, ref_info = model.step_pure(*args, cs.DT, options)
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], v.cpu().numpy(), err_msg=k)
    assert info["num_iter"] == int(ref_info.num_iter)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_timeseries_vmap_matches_loop_on_cuda(cuda, dtype):
    """``TimeSeries`` as one vmap over a stored run on the card against its
    per-state loop, for a field (von Mises stress) and a reduction (the
    minimum glottal width): 12 steps of the M5-3layers headline model read
    in memory (``chip_smoke.RunReader``); within 1e-12 (f64) or 1e-5
    (f32) of the series' largest entry."""
    import chip_smoke as cs
    from vf_fem_tpu_torch.postprocess import TimeSeries
    from vf_fem_tpu_torch.postprocess import solid as psl

    model, state0, controls, prop = cs.build(torch, cuda, "M5_3layers.msh", dtype)
    _, traj, _ = forward.integrate_pure(model, state0, controls, prop, cs.DT * np.arange(13))
    reader = cs.RunReader(state0, traj, {k: v[0] for k, v in controls.items()}, prop)
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    for measure in (psl.StressVonMisesField(model), psl.MinGlottalWidthFromSolid(model)):
        series = TimeSeries(measure)
        batched = series(reader)
        loop = series.assem_loop(reader, range(reader.size))
        assert batched.shape[0] == reader.size and np.all(np.isfinite(batched))
        np.testing.assert_allclose(batched, loop, rtol=rel, atol=rel * np.abs(loop).max())


# -- extruded 3D ------------------------------------------------------------------


@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_btd_sweep_3d_width(cuda, pair):
    """K6 at the 3D fold's width and depth (36 row blocks of 1280, a ring of
    two slots in every pair; f64 factors take 10 warps), both sweeps: each
    row within rtol 1e-13 / 1e-6 plus the order bound of the plain row from
    the kernel's own previous row, one launch a sweep; K6T is built there
    too (10 warps of several chunks) and is held the same way."""
    fdt, vdt = SWEEP_PAIRS[pair]
    plan = ops.sweep_plan(1280, fdt, vdt)
    assert plan.ring >= 2 and plan == kernels.built_sweep_plan(1280, fdt)
    _, _, Ad, gd = _random_sweep(pair, 1280, 36, seed=36, dev=cuda)
    rtol = 1e-13 if gd.dtype == torch.float64 else 1e-6
    n0 = ops.LAUNCHES["btd_sweep"]
    for rev in (False, True):
        out = ops.btd_sweep(Ad, gd, reverse=rev)
        ref, bound = ops.btd_sweep_rows_reference(Ad, gd, out, rev)
        assert_scatter_close(out, ref, bound, rtol)
    assert ops.LAUNCHES["btd_sweep"] == n0 + 2
    n0 = ops.LAUNCHES["btd_sweep_t"]
    for rev in (False, True):
        out = ops.btd_sweep_t(Ad, gd, reverse=rev)
        ref, bound = ops.btd_sweep_t_rows_reference(Ad, gd, out, rev)
        assert_scatter_close(out, ref, bound, rtol)
    assert ops.LAUNCHES["btd_sweep_t"] == n0 + 2


@pytest.fixture(scope="module")
def extruded(cuda):
    """The small extruded M5_CB_GA3 stack of ``chip_smoke.py`` phase 17 on
    the card and on the CPU."""
    import chip_smoke as cs

    return cs.extruded_small(torch, cuda), cs.extruded_small(torch, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_kernels_3d_shapes(extruded, dtype):
    """K1/K2 on the tetrahedral plan (nv = 4, 16 gathered channels, 3
    scattered) and K3 on the extruded fold's cell Jacobians (nld = 12)
    against their plain versions."""
    from vf_fem_tpu_torch.convert import to_tensors

    (model, *_), _ = extruded
    dev = model.device
    dp = model.solid.residual.banded_plan()
    nvert = model.solid.nvert
    assert dp.nv == 4
    rng = np.random.default_rng(3)
    F = torch.tensor(rng.standard_normal((16, nvert)), dtype=dtype, device=dev)
    loc = torch.tensor(rng.standard_normal((4, 3, dp.ncpad)), dtype=dtype, device=dev)
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    torch.testing.assert_close(banded.banded_gather(dp, F),
                               banded.banded_gather_reference(dp, F, dp.g), rtol=0, atol=0)
    assert_scatter_close(banded.banded_scatter(dp, loc, nvert),
                         banded.banded_scatter_reference(dp, loc, nvert, dp.s),
                         banded.scatter_order_bound(dp, loc, nvert, dp.s), rtol)
    solid = model.solid
    s0 = {k: torch.zeros(solid.ndof, dtype=torch.float64, device=dev) for k in "uva"}
    control = {"p1": torch.full((nvert,), 500.0, dtype=torch.float64, device=dev)}
    prop = to_tensors({k: model.prop[k] for k in model._solid_prop_keys}, dev, torch.float64)
    op = solid.jac_u_ebe(s0["u"], s0, control, prop, 1e-4)
    J = op.J_cells.to(dtype)
    assert J.shape[-1] == 12
    x = torch.tensor(rng.standard_normal(solid.ndof), dtype=dtype, device=dev)
    n0 = ops.LAUNCHES["ebe_matvec"]
    y = ops.ebe_matvec(J, x, op.cell_dofs)
    ref = ops.ebe_matvec_reference(J, x, op.cell_dofs)
    assert_scatter_close(y, ref, ops.dot_order_bound(
        ops.ebe_matvec_reference(J.abs(), x.abs(), op.cell_dofs), 12), rtol)
    assert ops.LAUNCHES["ebe_matvec"] == n0 + 1


def test_3d_step_runs_the_kernels(extruded):
    """The extruded stack's btd run on the card (f64 and bf16 factors)
    launches K1/K2 four times (fixed-3 chord with its trailing residual),
    K5 once and K6 six times a step (a two-sweep solve an iteration), as a
    replay of the captured step, and matches the CPU run, where no kernel
    launches: within 1e-10 of max|u| with f64 factors, 2e-8 with bf16 (the
    f64 factors of the two devices differ in their last bits, which moves
    some entries across a bf16 rounding boundary: 6.9e-9 on an H100)."""
    import chip_smoke as cs

    (model, s0, ctl, prop, times), (cmodel, cs0, cctl, cprop, _) = extruded
    n = len(times) - 1
    for run in ("btd", "btd16"):
        params = cs.EXTRUDED_SMALL_RUNS[run]
        _reset_launches()
        _, ctraj, _ = forward.integrate_pure(cmodel, cs0, cctl, cprop, times, params)
        assert sum(ops.LAUNCHES.values()) + sum(banded.LAUNCHES.values()) == 0
        forward.integrate_pure(model, s0, ctl, prop, times, params)  # captures the step
        _reset_launches()
        _, traj, infos = forward.integrate_pure(model, s0, ctl, prop, times, params)
        torch.cuda.synchronize()
        assert (banded.LAUNCHES["gather"], banded.LAUNCHES["scatter"]) == (4 * n, 4 * n)
        assert ops.LAUNCHES["newmark"] == n
        assert ops.LAUNCHES["btd_sweep"] == 2 * int(infos.num_iter.sum()) == 6 * n
        u, cu = traj["u"].cpu().numpy(), ctraj["u"].numpy()
        rel = 1e-10 if run == "btd" else 2e-8
        np.testing.assert_allclose(u, cu, rtol=0, atol=rel * np.abs(cu).max())


# -- SPIKE and the DOF-sharded step (slice 10) -------------------------------------


@pytest.mark.parametrize("slabs", [1, 4, 8, 16])
@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_btd_sweep_over_slabs(cuda, pair, slabs):
    """K6 over slabs (one launch, one cluster a slab) bit for bit against a
    launch a slab, and each slab's rows within their bound of the plain
    version's; 16 slabs of f64 factors run in waves of clusters."""
    fdt, vdt = SWEEP_PAIRS[pair]
    rng = np.random.default_rng(slabs)
    A = torch.tensor(rng.standard_normal((slabs, 12, 256, 256)) * (0.5 / 16)).to(fdt).to(cuda)
    g = torch.tensor(rng.standard_normal((slabs, 12, 256))).to(vdt).to(cuda)
    rtol = 1e-13 if vdt == torch.float64 else 1e-6
    for rev in (False, True):
        n0 = dict(ops.LAUNCHES)
        out = ops.btd_sweep(A, g, reverse=rev)
        assert ops.LAUNCHES["btd_sweep_slabs"] == n0["btd_sweep_slabs"] + 1
        alone = torch.stack([ops.btd_sweep(A[s], g[s], reverse=rev) for s in range(slabs)])
        torch.cuda.synchronize()
        assert torch.equal(out, alone)
        for s in range(slabs):
            ref, bound = ops.btd_sweep_rows_reference(A[s], g[s], out[s], rev)
            assert_scatter_close(out[s], ref, bound, rtol)


@pytest.mark.parametrize("bt, slabs, n", [(256, 1, 12), (256, 8, 12), (256, 16, 12),
                                           (1280, 4, 3)])
@pytest.mark.parametrize("pair", list(SWEEP_PAIRS))
def test_btd_sweep_t_over_slabs(cuda, pair, bt, slabs, n):
    """K6T over slabs (one launch, one cluster a slab, the slabs' boxes rows
    of one tensor map) bit for bit against a launch a slab, and each slab's
    rows within their bound of the plain version's, at the spike
    production width and at the 3D width; 16 slabs of f64 factors run in
    waves of clusters."""
    fdt, vdt = SWEEP_PAIRS[pair]
    rng = np.random.default_rng(slabs + bt)
    A = torch.tensor(rng.standard_normal((slabs, n, bt, bt)) * (0.5 / bt ** 0.5)).to(fdt).to(cuda)
    g = torch.tensor(rng.standard_normal((slabs, n, bt))).to(vdt).to(cuda)
    rtol = 1e-13 if vdt == torch.float64 else 1e-6
    for rev in (False, True):
        n0 = dict(ops.LAUNCHES)
        out = ops.btd_sweep_t(A, g, reverse=rev)
        assert ops.LAUNCHES["btd_sweep_t_slabs"] == n0["btd_sweep_t_slabs"] + 1
        assert ops.LAUNCHES["btd_sweep_t"] == n0["btd_sweep_t"]
        alone = torch.stack([ops.btd_sweep_t(A[s], g[s], reverse=rev) for s in range(slabs)])
        torch.cuda.synchronize()
        assert torch.equal(out, alone)
        for s in range(slabs):
            ref, bound = ops.btd_sweep_t_rows_reference(A[s], g[s], out[s], rev)
            assert_scatter_close(out[s], ref, bound, rtol)


def test_btd_sweep_t_slabs_rejects_bad_input(cuda):
    """On CUDA tensors K6T over slabs raises where it cannot launch, and
    never takes the plain version or a launch a slab: a width it is not
    built for, a cluster other than its plan's, mismatched shapes."""
    A = torch.zeros((2, 3, 256, 256), dtype=torch.bfloat16, device=cuda)
    g = torch.zeros((2, 3, 256), dtype=torch.float64, device=cuda)
    n0 = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="row blocks"):
        ops.btd_sweep_t(A[..., :64, :64].contiguous(), g[..., :64].contiguous())
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels._sweep_t_launch(A, g, False,
                                ops.sweep_t_plan(256, A.dtype, g.dtype)._replace(cluster=4))
    with pytest.raises(ValueError, match="btd_sweep_t"):
        ops.btd_sweep_t(A, g[:1])
    assert ops.LAUNCHES == n0


@pytest.fixture(scope="module")
def dd_small(cuda):
    """The DD fixture model of tests/test_torch_ddstep.py on the card and
    on the CPU (30 x 15 RCM vocal fold, KelvinVoigt + BernoulliSmoothMinSep)."""
    return port_dd_model(30, 15, cuda), port_dd_model(30, 15, "cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_t_matches_plain(dd_small, dtype):
    """K1/K2 on the stacked per-shard plans of a 4-shard partition against
    the plain versions (the gather exactly, the scatter to summation order)
    and each one's VJP against the other."""
    from vf_fem_tpu_torch.parallel import ddstep

    model, _ = dd_small
    p = ddstep.plan_dd(model, 4)
    dp = banded.to_device_stacked(ddstep.plan_dd_banded(model, p)["plans"], model.device)
    nvh = p.ndof_loc // p.dim + p.Bt // p.dim
    rng = np.random.default_rng(0)
    F = torch.tensor(rng.standard_normal((4, 13, nvh)), dtype=dtype, device=model.device)
    loc = torch.tensor(rng.standard_normal((4, dp.nv, 2, dp.ncpad)), dtype=dtype,
                       device=model.device)
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    n0 = dict(banded.LAUNCHES_T)
    Fg = F.clone().requires_grad_()
    out = banded.banded_gather_t(dp, Fg)
    torch.testing.assert_close(out, banded.banded_gather_t_reference(dp, F, dp.g),
                               rtol=0, atol=0)
    ct = torch.randn_like(out)
    (gF,) = torch.autograd.grad(out, Fg, ct)
    assert_scatter_close(gF, banded.banded_scatter_t_reference(dp, ct, nvh, dp.g),
                         banded.scatter_order_bound(dp, ct, nvh, dp.g), rtol)
    assert_scatter_close(banded.banded_scatter_t(dp, loc, nvh),
                         banded.banded_scatter_t_reference(dp, loc, nvh, dp.s),
                         banded.scatter_order_bound(dp, loc, nvh, dp.s), rtol)
    torch.cuda.synchronize()
    assert banded.LAUNCHES_T["gather_t"] == n0["gather_t"] + 1
    assert banded.LAUNCHES_T["scatter_t"] == n0["scatter_t"] + 2


def test_dd_step_on_cuda_matches_cpu(dd_small):
    """The banded DD step over 4 shards on the card against the same run
    on the CPU (plain versions of every kernel), within 1e-10 of max|u|;
    K1/K2 on the stacked plans and K6 over slabs carry it."""
    from vf_fem_tpu_torch.parallel import ddstep

    model, cmodel = dd_small
    times = 5e-5 * np.arange(9)
    params = {"jacobian_refresh_steps": 4, "assembly": "banded"}
    runs = []
    for m in (cmodel, model):
        s0, cs, prop = port_inputs(m)
        _reset_launches()
        banded.LAUNCHES_T.update(dict.fromkeys(banded.LAUNCHES_T, 0))
        runs.append(ddstep.DDIntegrator(m, 4, params).integrate_pure(s0, cs, prop, times))
    torch.cuda.synchronize()
    assert banded.LAUNCHES_T["gather_t"] > 0 and banded.LAUNCHES_T["scatter_t"] > 0
    assert ops.LAUNCHES["btd_sweep_slabs"] == 2 * int(runs[1][2].num_iter.sum())
    u, cu = runs[1][1]["u"].cpu().numpy(), runs[0][1]["u"].numpy()
    np.testing.assert_allclose(u, cu, rtol=0, atol=1e-10 * np.abs(cu).max())


def test_dd_auto_takes_banded_on_cuda(dd_small):
    """``assembly='auto'`` on a card model takes the banded cell pass (K1/K2
    on the stacked plans), as the JAX package takes it on the TPU; on the
    CPU model, the plain one."""
    from vf_fem_tpu_torch.parallel import ddstep

    model, cmodel = dd_small
    assert ddstep.DDIntegrator(model, 4, {"assembly": "auto"}).bplan is not None
    assert ddstep.DDIntegrator(cmodel, 4, {"assembly": "auto"}).bplan is None


def test_spike_solve_on_cuda(large_operator):
    """The SPIKE solve on the 23.7k Jacobian (8 partitions, f64 factors)
    on the card against the btd solve of the same matrix, two K6-over-slabs
    launches a solve."""
    from vf_fem_tpu_torch.solvers import btd, spike

    _, plan, blocks = large_operator
    r = torch.tensor(np.random.default_rng(0).standard_normal(plan.ndof),
                     device=blocks.device)
    fac = spike.spike_factor(plan, blocks, 8)
    n0 = ops.LAUNCHES["btd_sweep_slabs"]
    x = spike.spike_solve(plan, fac, r)
    xb = btd.btd_solve(plan, btd.btd_factor(plan, blocks), r)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["btd_sweep_slabs"] == n0 + 2
    assert float((x - xb).abs().max()) <= 1e-8 * float(xb.abs().max())


# -- batched sweeps (parallel.sweep) --------------------------------------------


@pytest.mark.parametrize("shape", [(64, 960), (256, 960), (3, 23754), (5, 123)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_batch_matches_plain(cuda, shape, dtype):
    """K5 over a (B, n) batch is one launch, bit-equal to its plain version;
    its vmap rule takes that launch; batched K5T (a CTA a variant) has the
    plain version's vector cotangents bit for bit and each variant's row
    within its summation-order bound, also at a row length whose variants
    start in different 16-byte phases (n = 123)."""
    from torch.func import vmap

    rng = np.random.default_rng(1)
    vb1, ab1, u1, u0, v0, a0 = (torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                             device=cuda) for _ in range(6))
    row = ops.newmark_row(ops.kernels.newmark.coefficients(1e-4, 7.5e-5), dtype, cuda)
    n0 = ops.LAUNCHES["newmark"]
    outs = ops.newmark_update_coefs(u1, u0, v0, a0, row)
    mapped = vmap(ops.newmark_step, in_dims=(0, 0, 0, 0, None))(u1, u0, v0, a0, row)
    assert ops.LAUNCHES["newmark"] == n0 + 2
    for o, m, r in zip(outs, mapped, ops.newmark_update_coefs_reference(u1, u0, v0, a0, row)):
        assert torch.equal(o, r) and torch.equal(m, r)
    t0 = ops.LAUNCHES["newmark_t"]
    got = ops.newmark_update_t_batch(vb1, ab1, u1, u0, v0, a0, row)
    assert ops.LAUNCHES["newmark_t"] == t0 + 1
    ref = ops.newmark_update_t_batch_reference(vb1, ab1, u1, u0, v0, a0, row)
    for g, r in zip(got[:4], ref[:4]):
        assert torch.equal(g, r)
    bound = ops.dot_order_bound(ops.newmark_update_t_batch_reference(
        vb1.abs(), ab1.abs(), u1.abs(), -u0.abs(), -v0.abs(), -a0.abs(), row.abs())[4].abs(),
        shape[1])
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    assert bool(((got[4] - ref[4]).abs() <= rtol * ref[4].abs() + bound).all())
    assert not bool(got[4][:, 6:].any())


@pytest.fixture(scope="module")
def sweep_small(cuda):
    model = port_vf_model(solid="KelvinVoigtWShape", nx=6, ny=3, device=cuda)
    state0, cs, prop = port_inputs(model)
    rng = np.random.default_rng(4)
    pb = {k: np.stack([v] * 16) for k, v in prop.items()}
    pb["emod"] = pb["emod"] * np.linspace(0.8, 1.2, 16)[:, None]
    pb["umesh"] = 1e-3 * rng.standard_normal(pb["umesh"].shape)
    return model, state0, cs, pb


@pytest.mark.parametrize("assembly", ["plain", "banded"])
def test_sweep_graph_equals_eager_on_cuda(sweep_small, assembly):
    """A fixed-iteration sweep with refresh windows replays one captured
    graph of the batched step, bit-equal to the batched eager loop, with one
    K5 launch a step for the batch; a row equals its variant alone (u, q, p
    at rtol 1e-10; v and a within 1e-12 of their max once u's gap is taken
    out)."""
    from vf_fem_tpu_torch.models.transient import solver_params

    model, state0, cs, pb = sweep_small
    params = solver_params({"jacobian_refresh_steps": 4, "jacobian_refresh_mode": "ns",
                            "jacobian_full_refresh_windows": 2, "stagnation_ratio": 0.5,
                            "fixed_iterations": 2, "assembly": assembly})
    times = 1e-4 * np.arange(11)
    eager = forward._integrate_eager(model, state0, cs, pb, times, params, (16, False))
    forward.integrate_batch_pure(model, state0, cs, pb, times, params)  # captures
    n0 = ops.LAUNCHES["newmark"]
    fin, traj, infos = forward.integrate_batch_pure(model, state0, cs, pb, times, params)
    assert ops.LAUNCHES["newmark"] == n0 + 10
    for k in fin:
        assert torch.equal(fin[k], eager[0][k]) and torch.equal(traj[k], eager[1][k].movedim(0, 1))
    one, one_traj, _ = forward.integrate_pure(model, state0, cs,
                                              {k: v[7] for k, v in pb.items()}, times, params)
    # the batched products round otherwise than one variant's: v and a
    # carry u's rounding gap scaled by 2/dt and 4/dt^2, taken out here
    du = (traj["u"][7] - one_traj["u"]).cpu().numpy()
    gap = newmark_gap(np.concatenate([np.zeros_like(du[:1]), du]), 0.0, 0.0, 1e-4)
    for k in one:
        ref = one[k].cpu().numpy()
        if k in gap:
            got = fin[k][7].cpu().numpy() - gap[k][-1]
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), k
        else:
            np.testing.assert_allclose(fin[k][7].cpu().numpy(), ref, rtol=1e-10,
                                       atol=1e-14 * max(1.0, np.abs(ref).max()), err_msg=k)


def test_sweep_grad_on_cuda_matches_cpu(sweep_small):
    """``sweep_grad`` on the card (K5T's batched launch backward) against the
    same sweep on the CPU: values and gradients within 1e-10 of each key's
    largest entry."""
    from vf_fem_tpu_torch.parallel import sweep_grad

    model, state0, cs, pb = sweep_small
    cpu = port_vf_model(solid="KelvinVoigtWShape", nx=6, ny=3)
    pb4 = {k: v[:4] for k, v in pb.items()}

    def loss(traj, controls, prop, times):
        return torch.sum(traj["u"][-1] ** 2) * 1e4 + 1e-6 * torch.sum(traj["q"] ** 2)

    times = 2e-5 * np.arange(6)
    t0 = ops.LAUNCHES["newmark_t"]
    v, g = sweep_grad(model, loss, state0, cs, pb4, times)
    assert ops.LAUNCHES["newmark_t"] == t0 + 4  # the last step's v1, a1 reach no loss
    vc, gc = sweep_grad(cpu, loss, state0, cs, pb4, times)
    torch.testing.assert_close(v.cpu(), vc, rtol=0, atol=1e-10 * vc.abs().max().item())
    for k in ("emod", "umesh"):
        torch.testing.assert_close(g[k].cpu(), gc[k], rtol=0,
                                   atol=1e-10 * gc[k].abs().max().item())


# -- a batch of variants on the block direct solvers and FSAI (slice 14) -----------


@pytest.mark.parametrize("transpose", [False, True], ids=["K6", "K6T"])
@pytest.mark.parametrize("shape", [(3, 5, 256), (2, 3, 4, 256), (2, 3, 1280), (2, 2, 2, 1280)],
                         ids=["chains-256", "slabs-256", "chains-1280", "slabs-1280"])
@pytest.mark.parametrize("pair", ["bf16-f64", "f64-f64", "e4m3-f64"])
def test_btd_sweep_vmap_is_the_slab_launch(cuda, pair, shape, transpose):
    """K6 / K6T under ``vmap`` over 4-D factors (a batch of chains) and 5-D
    ones (a batch of slabs) at Bt 256 and 1280: one launch over the folded
    chains, bit for bit the sweep of the leading axes and a launch a chain,
    both directions."""
    from torch.func import vmap

    fdt, vdt = SWEEP_PAIRS[pair]
    lead, n, bt = shape[:-2], shape[-2], shape[-1]
    rng = np.random.default_rng(sum(shape))
    A = torch.tensor(rng.standard_normal(lead + (n, bt, bt)) * (0.5 / bt ** 0.5)).to(fdt).to(cuda)
    g = torch.tensor(rng.standard_normal(lead + (n, bt))).to(vdt).to(cuda)
    sweep = ops.btd_sweep_t if transpose else ops.btd_sweep
    counter = "btd_sweep_t_slabs" if transpose else "btd_sweep_slabs"
    for rev in (False, True):
        n0 = dict(ops.LAUNCHES)
        got = vmap(sweep, in_dims=(0, 0, None))(A, g, rev)
        assert ops.LAUNCHES[counter] == n0[counter] + 1
        assert torch.equal(got, sweep(A, g, reverse=rev))
        Af, gf, out = A.reshape(-1, n, bt, bt), g.reshape(-1, n, bt), got.reshape(-1, n, bt)
        alone = torch.stack([sweep(Af[c], gf[c], reverse=rev) for c in range(Af.shape[0])])
        torch.cuda.synchronize()
        assert torch.equal(out, alone)


@pytest.mark.parametrize("n", [960, 23_754])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_t_batch_grid_matches_plain(cuda, dtype, n):
    """K5T over a batch of 8: one CTA a variant at n = 960 (the plan's, bit
    for bit an explicit one-CTA launch), a grid of several a variant at
    23,754 whose last CTA of each variant adds its sums by ticket: vector
    cotangents bit for bit the plain version's, each row within its order
    bound, the same bits in three launches and in a graph replay."""
    rng = np.random.default_rng(n)
    vecs = [torch.tensor(rng.standard_normal((8, n)), dtype=dtype, device=cuda)
            for _ in range(6)]
    row = ops.newmark_row(ops.kernels.newmark.coefficients(1e-4, 7.5e-5), dtype, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ctas = ops.newmark_t_batch_ctas(8, n, sms)
    assert (ctas == 1) == (n == 960)
    outs = [ops.newmark_update_t_batch(*vecs, row) for _ in range(3)]
    one = ops.newmark_update_t_batch(*vecs, row, ctas=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.newmark_update_t_batch(*vecs, row)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.newmark_update_t_batch(*vecs, row)
    graph.replay()
    torch.cuda.synchronize()
    ref = ops.newmark_update_t_batch_reference(*vecs, row)
    for g, o, r in zip(outs[0][:4], one[:4], ref[:4]):
        assert torch.equal(g, r) and torch.equal(o, r)
    for o in outs[1:] + [captured]:
        assert torch.equal(o[4], outs[0][4])
    if n == 960:
        assert torch.equal(outs[0][4], one[4])
    vb1, ab1, u1, u0, v0, a0 = vecs
    bound = ops.dot_order_bound(ops.newmark_update_t_batch_reference(
        vb1.abs(), ab1.abs(), u1.abs(), -u0.abs(), -v0.abs(), -a0.abs(), row.abs())[4].abs(), n)
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    for got in (outs[0][4], one[4]):
        assert bool(((got - ref[4]).abs() <= rtol * ref[4].abs() + bound).all())
        assert not bool(got[:, 6:].any())


@pytest.mark.parametrize("solver", ["btd", "spike"])
def test_batched_block_solver_graph_on_cuda(cuda, solver):
    """A batch of 3 variants on 'btd' / 'spike' (bf16 factors, refresh 4,
    fixed-3) replays one graph of the batched step, bit-equal to the batched
    eager loop; every K6 launch is over the batch's chains (none over one
    chain), as many as one variant's run makes; each row within 5e-7 of
    max|u| of its variant's run alone."""
    model = port_vf_model("KelvinVoigtWEpithelium", 24, 6, device=cuda, reorder="rcm")
    state0, cs, prop = port_inputs(model)
    pb = {k: np.stack([v] * 3) for k, v in prop.items()}
    pb["emod"] = pb["emod"] * np.array([0.8, 1.0, 1.2])[:, None]
    params = {"assembly": "banded", "linear_solver": solver, "spike_partitions": 2,
              "btd_store_dtype": "bfloat16", "jacobian_refresh_steps": 4, "fixed_iterations": 3,
              "fixed_tail_residual": False, "stagnation_ratio": 0.5}
    times = 1e-4 * np.arange(11)
    from vf_fem_tpu_torch.models.transient import solver_params

    eager = forward._integrate_eager(model, state0, cs, pb, times, solver_params(params),
                                     (3, False))
    forward.integrate_batch_pure(model, state0, cs, pb, times, params)  # captures
    n0 = dict(ops.LAUNCHES)
    fin, traj, _ = forward.integrate_batch_pure(model, state0, cs, pb, times, params)
    batched = {k: ops.LAUNCHES[k] - n0[k] for k in ("btd_sweep", "btd_sweep_slabs")}
    for k in fin:
        assert torch.equal(fin[k], eager[0][k]) and torch.equal(traj[k], eager[1][k].movedim(0, 1))
    n0 = dict(ops.LAUNCHES)
    one, _, _ = forward.integrate_pure(model, state0, cs, {k: v[2] for k, v in pb.items()},
                                       times, params)
    single = {k: ops.LAUNCHES[k] - n0[k] for k in ("btd_sweep", "btd_sweep_slabs")}
    assert batched["btd_sweep"] == 0 and batched["btd_sweep_slabs"] == sum(single.values())
    scale = one["u"].abs().max().item()
    assert (fin["u"][2] - one["u"]).abs().max().item() <= 5e-7 * scale


def test_fsai_batch_graph_on_cuda(cuda):
    """A batch of 3 FSAI variants (tests/test_fsai.py's 8 x 4 model) on the
    headline settings, scaled down: the graph of the batched step bit-equal
    to the batched eager loop, ``bracketed`` included, no lagged step."""
    from vf_fem_tpu_torch.load import load_fsai_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.models.transient import solver_params
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    from port_fixtures import HEADLINE_SMALL

    mesh = vocal_fold_mesh(8, 4)
    model = load_fsai_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep, num_tube=12,
                            device=cuda)
    ymax = mesh.coords[:, 1].max()
    p = model.prop
    for k, v in dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, kcontact=1e8, rho_air=1.1225e-3,
                     zeta_min=1e-3, zeta_sep=1e-3, proploss=1.0).items():
        p[k][:] = v
    p["ycontact"][:] = ymax + 0.005
    p["ymid"][:] = ymax + 0.01
    p["area"][:] = np.concatenate([np.full(6, 0.6), np.full(6, 2.6)])
    model.control["psub"][:] = 8000.0
    state0, cs, prop = port_inputs(model)
    pb = {k: np.stack([v] * 3) for k, v in prop.items()}
    pb["emod"] = pb["emod"] * np.array([0.8, 1.0, 1.2])[:, None]
    params = {**HEADLINE_SMALL, "assembly": "banded"}
    times = model.dt * np.arange(12)
    eager = forward._integrate_eager(model, state0, cs, pb, times, solver_params(params),
                                     (3, False))
    forward.integrate_batch_pure(model, state0, cs, pb, times, params)  # captures
    fin, traj, infos = forward.integrate_batch_pure(model, state0, cs, pb, times, params)
    for k in fin:
        assert torch.equal(fin[k], eager[0][k]) and torch.equal(traj[k], eager[1][k].movedim(0, 1))
    assert torch.equal(infos.bracketed, eager[2].bracketed.movedim(0, 1))
    assert bool(infos.bracketed.all())
