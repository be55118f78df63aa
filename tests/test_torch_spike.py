"""
The port's SPIKE solver (``solvers.spike``, ``linear_solver='spike'``)
against the JAX package on the CPU in f64: the factor arrays and solves on the same
block-banded Jacobian (KelvinVoigt on the RCM-renumbered
``vocal_fold_mesh(20, 10)`` at rest under 800 Ba, as
``tests/test_ddstep.py:53-83``), bf16 storage, the plain slab sweeps of K6
and K6T, the transposed parts (``with_transpose``: the spikes of ``A^T``,
its reduced factors) and the transposed solve ``spike_solve_t``
(``tests/test_spike.py:40-74``), and an FSI trajectory through
``linear_solver='spike'`` (``tests/test_spike.py:77-143``); the gradients
and tangents through it are ``tests/test_torch_spike_grad.py``'s.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu.load import load_solid_model as jload_solid
from vf_fem_tpu.mesh import vocal_fold_mesh as jvocal_fold_mesh
from vf_fem_tpu.mesh.reorder import rcm_mesh as jrcm_mesh
from vf_fem_tpu.residuals import solid as jslr
from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu.solvers import spike as jspike
from vf_fem_tpu_torch import forward, ops
from vf_fem_tpu_torch.load import load_solid_model
from vf_fem_tpu_torch.mesh import vocal_fold_mesh
from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
from vf_fem_tpu_torch.models.transient import solver_params
from vf_fem_tpu_torch.residuals import solid as slr
from vf_fem_tpu_torch.solvers import spike

from port_fixtures import port_dd_model, port_inputs, set_dd_props

F32_U = 2.0 ** -24  # f32 unit roundoff
SOLID_PROPS = dict(emod=5e4, nu=0.45, rho=1.0, eta=3.0, ycontact=10.0, kcontact=1e8)
PARTS = [1, 2, 3, 8]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These runs are thousands of small tensor ops a step: on one thread,
    since the suite's parallel workers would oversubscribe the cores with
    intra-op threads that wait on each other at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def system():
    """(JAX plan, JAX blocks, dense A, port plan, the same blocks as a
    tensor): the Jacobian at rest under 800 Ba."""
    jm = jload_solid(jrcm_mesh(jvocal_fold_mesh(20, 10)), jslr.KelvinVoigt)
    for k, v in SOLID_PROPS.items():
        jm.prop[k][:] = v
    jm.set_prop(jm.prop)
    sprop = {k: jnp.asarray(v) for k, v in jm.prop.sub_items()}
    s0 = {k: jnp.zeros(jm.ndof) for k in ("u", "v", "a")}
    ctrl = {"p1": jnp.full(jm.nvert, 800.0)}
    op = jm.jac_u_ebe(s0["u"], s0, ctrl, sprop, 1e-4)
    jp = jm._get_bsb_plan()
    jb = jbsb.bsb_fill(jp, [op.J_cells, op.J_facets])
    # the dense matrix from the port's own model (the same Jacobian)
    tm = load_solid_model(rcm_mesh(vocal_fold_mesh(20, 10)), slr.KelvinVoigt, device="cpu")
    for k, v in SOLID_PROPS.items():
        tm.prop[k][:] = v
    z = torch.zeros(tm.ndof, dtype=torch.float64)
    A = tm.jac_u_dense(z, {"u": z, "v": z, "a": z},
                       {"p1": torch.full((tm.nvert,), 800.0, dtype=torch.float64)},
                       {k: torch.as_tensor(v) for k, v in tm.prop.items()}, 1e-4).numpy()
    tp = tm.bsb_plan()[0]
    assert (tp.b, tp.h, tp.nb, tp.nblk, tp.ndof) == (jp.b, jp.h, jp.nb, jp.nblk, jp.ndof)
    return jp, jb, A, tp, torch.as_tensor(np.array(jb))


@functools.lru_cache(maxsize=None)
def _jax_run(n_parts, store, rhs_seed=0):
    """The JAX package's factors (with the transposed parts), solve and
    transposed solve of the module's system (each configuration compiled
    once for the module's tests)."""
    jp, jb = _SYSTEM["jp"], _SYSTEM["jb"]
    fj = jspike.spike_factor(jp, jb, n_parts=n_parts, store_dtype=store,
                             with_transpose=True)
    r = jnp.asarray(np.random.default_rng(rhs_seed).standard_normal(jp.ndof))
    return (fj, np.asarray(jspike.spike_solve(jp, fj, r)),
            np.asarray(jspike.spike_solve_t(jp, fj, r)))


_SYSTEM = {}


@pytest.fixture(scope="module", autouse=True)
def _register(system):
    _SYSTEM.update(jp=system[0], jb=system[1])
    yield
    _jax_run.cache_clear()


@pytest.fixture(scope="module")
def rhs(system):
    return np.random.default_rng(0).standard_normal(system[2].shape[0])


@pytest.mark.parametrize("n_parts", PARTS)
def test_factors_match_jax(system, n_parts):
    """Every factor array within 1e-12 of its largest entry of the JAX
    package's (the serial inverses amplify roundoff by the Schur
    complements' conditioning); with 8 slabs for 4 super-rows the tail
    slabs are identity padding."""
    _, _, _, tp, tb = system
    fj = _jax_run(n_parts, None)[0]
    ft = spike.spike_factor(tp, tb, n_parts=n_parts)
    for f in ("Sinv", "P", "Q", "V", "W"):
        a, r = getattr(ft, f), np.asarray(getattr(fj, f))
        assert tuple(a.shape) == r.shape and a.dtype == torch.float64, f
        assert _rel(a, r) <= 1e-12, f
    for a, r in zip(ft.red, fj.red):
        assert _rel(a, r) <= 1e-12
    assert _rel(ft.d, fj.d) <= 1e-15


@pytest.mark.parametrize("n_parts", PARTS)
def test_solve_matches_jax_and_dense(system, rhs, n_parts):
    """The solve within 1e-12 of max|x| of the JAX package's and at
    rtol 1e-8 of the dense solve (``tests/test_spike.py``'s gate); on the
    CPU no kernel launches."""
    _, _, A, tp, tb = system
    ft = spike.spike_factor(tp, tb, n_parts=n_parts)
    r = torch.as_tensor(rhs)
    before = dict(ops.LAUNCHES)
    x = spike.spike_solve(tp, ft, r)
    assert ops.LAUNCHES == before
    assert _rel(x, _jax_run(n_parts, None)[1]) <= 1e-12
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, rhs), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n_parts", PARTS)
def test_bf16_storage_matches_jax(system, rhs, n_parts):
    """bf16-stored factors: the solve within the f32 summation bound of one
    row block, 2 gamma_Bt(f32), of the JAX package's bf16 solve (their
    f32 sums run in another order)."""
    _, _, _, tp, tb = system
    ft = spike.spike_factor(tp, tb, n_parts=n_parts, store_dtype="bfloat16")
    for f in ("Sinv", "P", "Q", "V", "W"):
        assert getattr(ft, f).dtype == torch.bfloat16, f
    assert ft.Sinv_r.dtype == torch.float64
    x = spike.spike_solve(tp, ft, torch.as_tensor(rhs))
    Bt = ft.Sinv.shape[-1]
    assert _rel(x, _jax_run(n_parts, "bfloat16")[1]) <= 2 * Bt * F32_U / (1 - Bt * F32_U)


@pytest.mark.parametrize("n_parts", PARTS)
def test_transposed_factors_match_jax(system, n_parts):
    """``with_transpose``: the spikes of ``A^T`` (``Vh``, ``Wh``) and its
    reduced factors within 1e-12 of their largest entry of the JAX
    package's, and every other field the forward-only factors' bit for
    bit."""
    _, _, _, tp, tb = system
    fj = _jax_run(n_parts, None)[0]
    ft = spike.spike_factor(tp, tb, n_parts=n_parts, with_transpose=True)
    for f in ("Vh", "Wh"):
        a, r = getattr(ft, f), np.asarray(getattr(fj, f))
        assert tuple(a.shape) == r.shape and a.dtype == torch.float64, f
        assert _rel(a, r) <= 1e-12, f
    for a, r in zip(ft.red_t, fj.red_t):
        assert _rel(a, r) <= 1e-12
    plain = spike.spike_factor(tp, tb, n_parts=n_parts)
    assert plain.Vh is None and plain.Sinv_rt is None
    for f in spike.SPIKEFactors._fields[:9]:
        assert torch.equal(getattr(ft, f), getattr(plain, f)), f


@pytest.mark.parametrize("n_parts", PARTS)
def test_solve_t_matches_jax_and_dense(system, rhs, n_parts):
    """``spike_solve_t`` within 1e-12 of max|x| of the JAX package's and at
    rtol 1e-8 of the dense ``A^T`` solve (``tests/test_spike.py:50-52``);
    factors without the transposed parts refuse it."""
    _, _, A, tp, tb = system
    ft = spike.spike_factor(tp, tb, n_parts=n_parts, with_transpose=True)
    r = torch.as_tensor(rhs)
    before = dict(ops.LAUNCHES)
    x = spike.spike_solve_t(tp, ft, r)
    assert ops.LAUNCHES == before
    assert _rel(x, _jax_run(n_parts, None)[2]) <= 1e-12
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A.T, rhs), rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match="with_transpose"):
        spike.spike_solve_t(tp, spike.spike_factor(tp, tb, n_parts=n_parts), r)


@pytest.mark.parametrize("n_parts", PARTS)
def test_bf16_storage_t_matches_jax(system, rhs, n_parts):
    """bf16-stored factors, transposed: ``Vh`` and ``Wh`` stored bf16 and
    the reduced factors f64 (``vf_fem_tpu/solvers/spike.py:409-418``), and
    the transposed solve within the f32 summation bound of one row block of
    the JAX package's bf16 transposed solve."""
    _, _, _, tp, tb = system
    ft = spike.spike_factor(tp, tb, n_parts=n_parts, store_dtype="bfloat16",
                            with_transpose=True)
    for f in ("Sinv", "P", "Q", "V", "W", "Vh", "Wh"):
        assert getattr(ft, f).dtype == torch.bfloat16, f
    assert all(t.dtype == torch.float64 for t in ft.red_t)
    x = spike.spike_solve_t(tp, ft, torch.as_tensor(rhs))
    Bt = ft.Sinv.shape[-1]
    assert _rel(x, _jax_run(n_parts, "bfloat16")[2]) <= 2 * Bt * F32_U / (1 - Bt * F32_U)


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.float64), (torch.float64, torch.float64),
                                  (torch.float32, torch.float32)], ids=["bf16-f64", "f64", "f32"])
def test_plain_slab_sweep_is_unbatched_sweeps(pair):
    """The plain version of K6 over slabs is S unbatched plain sweeps, bit
    for bit, both directions."""
    fdt, vdt = pair
    rng = np.random.default_rng(1)
    A = torch.tensor(rng.standard_normal((5, 7, 128, 128)) * 0.05).to(fdt)
    g = torch.tensor(rng.standard_normal((5, 7, 128))).to(vdt)
    for rev in (False, True):
        out = ops.btd_sweep(A, g, reverse=rev)
        assert torch.equal(out, torch.stack([ops.btd_sweep(A[s], g[s], reverse=rev)
                                             for s in range(5)]))
        assert torch.equal(out, ops.btd_sweep_slabs_reference(A, g, rev))


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.float64), (torch.float64, torch.float64),
                                  (torch.float32, torch.float32)], ids=["bf16-f64", "f64", "f32"])
def test_plain_slab_sweep_t_is_unbatched_sweeps(pair):
    """The plain version of K6T over slabs is S unbatched plain transposed
    sweeps, bit for bit, both directions."""
    fdt, vdt = pair
    rng = np.random.default_rng(2)
    A = torch.tensor(rng.standard_normal((5, 7, 128, 128)) * 0.05).to(fdt)
    g = torch.tensor(rng.standard_normal((5, 7, 128))).to(vdt)
    for rev in (False, True):
        out = ops.btd_sweep_t(A, g, reverse=rev)
        assert torch.equal(out, torch.stack([ops.btd_sweep_t(A[s], g[s], reverse=rev)
                                             for s in range(5)]))
        assert torch.equal(out, ops.btd_sweep_t_slabs_reference(A, g, rev))


def test_spike_fsi_trajectory():
    """``linear_solver='spike'`` (4 partitions, factors refreshed every 6
    steps) reproduces the JAX package's exact-Jacobian trajectory of
    ``tests/test_spike.py:77-143`` (rtol 1e-8)."""
    from vf_fem_tpu.load import load_fsi_model as jload_fsi
    from vf_fem_tpu.residuals import fluid as jflr

    mesh = jrcm_mesh(jvocal_fold_mesh(10, 5))
    jm = jload_fsi(mesh, jslr.KelvinVoigt, jflr.BernoulliSmoothMinSep, coupling="explicit")
    set_dd_props(jm.prop, jm.control, mesh.coords[:, 1].max())
    jm.set_prop(jm.prop)
    jm.set_control(jm.control)
    state0 = {k: np.zeros_like(np.asarray(v)) for k, v in jm.state0.sub_items()}
    times = np.asarray(5e-5 * np.arange(13))
    _, jt, _ = jforward.integrate_pure(jm, state0, jforward._stack_controls(jm, [jm.control]),
                                       jm.prop_to_dict(jm.prop), times,
                                       {"jacobian_refresh_steps": 1})
    tm = port_dd_model(10, 5)
    _, tt, info = forward.integrate_pure(
        tm, *port_inputs(tm), times,
        {"linear_solver": "spike", "spike_partitions": 4, "jacobian_refresh_steps": 6})
    np.testing.assert_allclose(tt["u"].numpy(), np.asarray(jt["u"]), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tt["q"].numpy(), np.asarray(jt["q"]), rtol=1e-8, atol=1e-12)


def test_solver_params_take_spike():
    p = solver_params({"linear_solver": "spike", "spike_partitions": 4,
                       "btd_store_dtype": "bfloat16"})
    assert p["linear_solver"] == "spike"
