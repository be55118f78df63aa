"""
The port's DOF-sharded explicit step (``parallel.ddstep``: the shards
stacked on one device) and K1/K2 on stacked per-shard plans
(``fem.banded.banded_gather_t`` / ``banded_scatter_t``) against the JAX
package on the CPU in f64: the plans of ``plan_dd`` / ``plan_dd_banded``
array by array, the traced-plan gather and scatter and their VJPs, the DD
step's SPIKE solve against the single-device ``spike_solve``, and DD
trajectories against the JAX package's single-device run at the gates of
``tests/test_ddstep.py:85-120`` and ``:499-573``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu.fem import banded as jbanded
from vf_fem_tpu.load import load_fsi_model as jload_fsi
from vf_fem_tpu.mesh import vocal_fold_mesh as jvocal_fold_mesh
from vf_fem_tpu.mesh.reorder import rcm_mesh as jrcm_mesh
from vf_fem_tpu.parallel import ddstep as jddstep
from vf_fem_tpu.residuals import fluid as jflr, solid as jslr
from vf_fem_tpu_torch import forward, statefile as sf
from vf_fem_tpu_torch.convert import to_tensors
from vf_fem_tpu_torch.fem import banded
from vf_fem_tpu_torch.load import load_fsai_model, load_fsi_model
from vf_fem_tpu_torch.mesh import vocal_fold_mesh
from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
from vf_fem_tpu_torch.parallel import ddstep
from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr
from vf_fem_tpu_torch.solvers import spike

from port_fixtures import port_dd_model, port_inputs, set_dd_props


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These runs are thousands of small tensor ops a step: on one thread,
    since the suite's parallel workers would oversubscribe the cores with
    intra-op threads that wait on each other at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(nx, ny):
    mesh = jrcm_mesh(jvocal_fold_mesh(nx, ny))
    model = jload_fsi(mesh, jslr.KelvinVoigt, jflr.BernoulliSmoothMinSep, coupling="explicit")
    set_dd_props(model.prop, model.control, mesh.coords[:, 1].max())
    model.set_prop(model.prop)
    model.set_control(model.control)
    return model


@pytest.fixture(scope="module")
def small():
    """The 20 x 10 fold of tests/test_ddstep.py (4 super-rows: at 8 shards
    four of them are empty), JAX and port."""
    return _jax_model(20, 10), port_dd_model(20, 10)


@pytest.fixture(scope="module")
def large():
    """The 40 x 20 fold of tests/test_ddstep.py:_make_model, and the JAX
    package's single-device run of :85-120 (refresh 1, 52 steps)."""
    jm = _jax_model(40, 20)
    state0 = {k: np.zeros_like(np.asarray(v)) for k, v in jm.state0.sub_items()}
    times = np.asarray(5e-5 * np.arange(53))
    fin, traj, _ = jforward.integrate_pure(
        jm, state0, jforward._stack_controls(jm, [jm.control]), jm.prop_to_dict(jm.prop),
        times, {"jacobian_refresh_steps": 1})
    ref = ({k: np.asarray(v) for k, v in fin.items()},
           {k: np.asarray(v) for k, v in traj.items()})
    return jm, port_dd_model(40, 20), times, ref


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("size", ["small", "large"])
def test_plans_match_jax(request, size, S):
    """Every array of ``plan_dd`` and ``plan_dd_banded`` equals the JAX
    package's (numpy on both sides), with empty shards at 20 x 10 / 8."""
    jm, tm = request.getfixturevalue(size)[:2]
    jp, tp = jddstep.plan_dd(jm, S), ddstep.plan_dd(tm, S)
    for f in jp._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    jb, tb = jddstep.plan_dd_banded(jm, jp), ddstep.plan_dd_banded(tm, tp)
    assert tuple(tb["meta"]) == tuple(jb["meta"])
    for k, v in jb["arrays"].items():
        np.testing.assert_array_equal(tb["arrays"][k], v, err_msg=k)
    if size == "small" and S == 8:
        assert (tp.cell_mask.sum(axis=1) == 0).any()


@pytest.mark.parametrize("S", [4, 8])
def test_banded_t_matches_jax(small, S):
    """``banded_gather_t`` / ``banded_scatter_t`` on the stacked plans
    against the JAX package's on each shard's traced plan: the gather
    exactly, the scatter within 1e-13 of its largest entry; each one's VJP
    is the other (against ``jax.vjp`` of the JAX functions)."""
    _, tm = small
    tp = ddstep.plan_dd(tm, S)
    bp = ddstep.plan_dd_banded(tm, tp)
    dp = banded.to_device_stacked(bp["plans"], "cpu")
    meta = tuple(bp["meta"]) + (None,)
    nvh = tp.ndof_loc // tp.dim + tp.Bt // tp.dim
    rng = np.random.default_rng(S)
    F = rng.standard_normal((S, 11, nvh))
    loc = rng.standard_normal((S, dp.nv, 2, dp.ncpad))
    ct_g = rng.standard_normal((S, dp.nv, 11, dp.ncpad))
    ct_s = rng.standard_normal((S, 2, nvh))
    Ft = torch.tensor(F, requires_grad=True)
    lt = torch.tensor(loc, requires_grad=True)
    g = banded.banded_gather_t(dp, Ft)
    s = banded.banded_scatter_t(dp, lt, nvh)
    (gF,) = torch.autograd.grad(g, Ft, torch.tensor(ct_g))
    (gl,) = torch.autograd.grad(s, lt, torch.tensor(ct_s))
    a = bp["arrays"]
    for k in range(S):
        args = (jnp.asarray(a["bb_base"][k]),)
        jg, vjp_g = jax.vjp(lambda x: jbanded.banded_gather_t(meta, *args, jnp.asarray(a["bb_dg"][k]), x),
                            jnp.asarray(F[k]))
        js, vjp_s = jax.vjp(lambda x: jbanded.banded_scatter_t(meta, *args, jnp.asarray(a["bb_ds"][k]),
                                                               x, nvh), jnp.asarray(loc[k]))
        np.testing.assert_array_equal(g[k].detach().numpy(), np.asarray(jg))
        ref = np.asarray(js)
        assert np.abs(s[k].detach().numpy() - ref).max() <= 1e-13 * np.abs(ref).max()
        ref = np.asarray(vjp_g(jnp.asarray(ct_g[k]))[0])
        assert np.abs(gF[k].numpy() - ref).max() <= 1e-13 * np.abs(ref).max()
        np.testing.assert_array_equal(gl[k].numpy(), np.asarray(vjp_s(jnp.asarray(ct_s[k]))[0]))
    # each VJP is the other op on the same stacked plan
    assert torch.equal(gF, banded.banded_scatter_t_reference(dp, torch.tensor(ct_g), nvh, dp.g))
    assert torch.equal(gl, banded.banded_gather_t_reference(dp, torch.tensor(ct_s), dp.s))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_dd_solve_matches_spike_solve(small, S):
    """The DD step's factors and solve (each shard's slab filled with the
    previous shard's spill, equilibrated with its neighbours' scale halos,
    SPIKE on the stacked slabs) against the single-device ``spike_solve``
    with S partitions of the same Jacobian (the predictor of a seeded
    state): within 1e-12 of max|x| (the two fills sum in other orders)."""
    _, tm = small
    dd = ddstep.DDIntegrator(tm, S, {"jacobian_refresh_steps": 1})
    p = dd.plan
    rng = np.random.default_rng(S)
    state = {k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in tm.state0.items()}
    for k in ("u", "v", "a"):
        state[k] = torch.as_tensor(1e-3 * rng.standard_normal(tm.solid.ndof))
    prop = to_tensors(tm.prop, "cpu", torch.float64)
    dt = 5e-5
    ref_fac = tm.factorize(state, None, prop, dt,
                           {"linear_solver": "spike", "spike_partitions": S})
    r = rng.standard_normal(tm.solid.ndof)
    x_ref = spike.spike_solve(tm.solid.bsb_plan()[0], ref_fac, torch.as_tensor(r))

    def shard(v):
        return torch.nn.functional.pad(torch.as_tensor(v), (0, p.ndof_pad - p.ndof)).reshape(S, -1)

    fac = dd._factorize_step({**state, **{k: shard(state[k]) for k in "uva"}}, prop, dt)
    assert fac.d.shape == (S, p.ndof_loc) and fac.Sinv.shape == ref_fac.Sinv.shape
    x = dd._spike_apply(fac, shard(r)).reshape(-1)[:p.ndof]
    assert torch.abs(x - x_ref).max() <= 1e-12 * torch.abs(x_ref).max()


def test_banded_assembly_refuses_plain(small, monkeypatch):
    """'auto' takes 'plain' on the CPU, and 'banded' on CUDA; where the
    partition cannot take the banded plan, 'banded' and 'auto' on a CUDA
    model raise and never take 'plain'."""
    _, tm = small
    assert ddstep.DDIntegrator(tm, 4, {"assembly": "auto"}).bplan is None
    monkeypatch.setattr(ddstep, "plan_dd_banded", lambda model, plan: None)
    with pytest.raises(ValueError, match="assembly='plain'"):
        ddstep.DDIntegrator(tm, 4, {"assembly": "banded"})
    monkeypatch.setattr(tm, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="assembly='plain'"):
        ddstep.DDIntegrator(tm, 4, {"assembly": "auto"})


@pytest.mark.parametrize("assembly", ["plain", "banded"])
@pytest.mark.parametrize("S", [4, 8])
def test_dd_matches_single_device(large, S, assembly):
    """The sharded loop (refresh 8, adaptive Newton) against the JAX
    package's single-device exact-Jacobian run over 52 coupled steps
    (``tests/test_ddstep.py:85-120``): max|du| < 1e-10 max|u|, q at rtol
    1e-9, the final u at rtol 1e-9."""
    _, tm, times, (fin_j, traj_j) = large
    dd = ddstep.DDIntegrator(tm, S, {"jacobian_refresh_steps": 8, "assembly": assembly})
    assert (dd.bplan is not None) == (assembly == "banded")
    fin, traj, infos = dd.integrate_pure(*port_inputs(tm), times)
    u, uj = traj["u"].numpy(), traj_j["u"]
    assert np.abs(u - uj).max() < 1e-10 * np.abs(uj).max()
    np.testing.assert_allclose(traj["q"].numpy(), traj_j["q"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fin["u"].numpy(), fin_j["u"], rtol=1e-9, atol=1e-14)
    assert np.all(np.isfinite(infos.abs_err.numpy()))


def test_dd_banded_empty_slabs(small):
    """Banded assembly on a partition with cell-less tail shards (20 x 10
    over 8): finite and within 1e-9 of the plain assembly
    (``tests/test_ddstep.py:538-573``)."""
    _, tm = small
    times = 5e-5 * np.arange(9)
    runs = {asm: ddstep.DDIntegrator(tm, 8, {"jacobian_refresh_steps": 4, "assembly": asm})
            .integrate_pure(*port_inputs(tm), times)[1]["u"].numpy()
            for asm in ("plain", "banded")}
    assert np.all(np.isfinite(runs["banded"]))
    assert np.abs(runs["banded"] - runs["plain"]).max() < 1e-9 * np.abs(runs["plain"]).max()


def test_dd_integrate_writes_statefile(small, tmp_path):
    """``DDIntegrator.integrate`` writes the statefile ``forward.integrate``
    writes (``tests/test_ddstep.py:425-468``): the final state stored, the
    measure indices, and the trajectory within 1e-9 of the single-device
    one."""
    _, tm = small
    times = 5e-5 * np.arange(13)
    ini = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    dd = ddstep.DDIntegrator(tm, 4, {"jacobian_refresh_steps": 4})
    with sf.StateFile(tm, str(tmp_path / "dd.h5"), mode="w") as f:
        fin, info = dd.integrate(f, ini, [tm.control], tm.prop, times,
                                 idx_meas=np.array([0, 5]))
        assert f.size == len(times)
        stored = f.get_state(f.size - 1)
        for k in ("u", "v", "a", "q", "p"):
            np.testing.assert_allclose(stored[k], fin[k], rtol=1e-12, atol=0)
        assert list(np.asarray(f.get_meas_indices())) == [0, 5]
        dd5 = f.get_state(5)
    assert info["diverged"] is False
    with sf.StateFile(tm, str(tmp_path / "ref.h5"), mode="w") as f:
        forward.integrate(tm, f, ini, [tm.control], tm.prop, times,
                          newton_solver_prm={"jacobian_refresh_steps": 1})
        ref5 = f.get_state(5)
    assert np.abs(dd5["u"] - ref5["u"]).max() < 1e-9 * np.abs(ref5["u"]).max()


def _raising(case):
    mesh = rcm_mesh(vocal_fold_mesh(8, 4))
    if case == "implicit":
        return load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                              coupling="implicit", device="cpu"), {}
    if case == "fsai":
        return load_fsai_model(mesh, slr.KelvinVoigt, flr.BernoulliAreaRatioSep,
                               num_tube=8, device="cpu"), {}
    if case == "umesh":
        return load_fsi_model(mesh, slr.KelvinVoigtWShape, flr.BernoulliSmoothMinSep,
                              device="cpu"), {}
    return port_dd_model(8, 4), {"dp_axis": "dp"} if case == "dp_axis" else {}


@pytest.mark.parametrize("case", ["implicit", "fsai", "dp_axis", "umesh"])
def test_unported_cases_raise(case):
    """What the port's DD step does not take raises, naming the ROADMAP item."""
    model, kw = _raising(case)
    with pytest.raises(NotImplementedError, match="ROADMAP item 22"):
        dd = ddstep.DDIntegrator(model, 2, {"jacobian_refresh_steps": 2}, **kw)
        s0, cs, prop = port_inputs(model)
        s0 = {k: torch.tensor(v, requires_grad=True) for k, v in s0.items()}
        dd.integrate_pure(s0, cs, prop, 5e-5 * np.arange(3))
