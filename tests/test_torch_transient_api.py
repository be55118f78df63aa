"""
The stateful model API of the port (``set_*``, ``assem_*``,
``solve_state1``, the Newmark-structured solves) against the JAX
package's on the CPU in f64:

- the port counterparts of ``tests/test_transient_api.py``'s eight tests,
  at their tolerances;
- each stateful method of ``SolidModel``, ``FluidModel``,
  ``ExplicitFSIModel``, ``ImplicitFSIModel``, ``ExplicitFSAIModel`` and
  ``WRAnalog`` against the JAX model's on the same inputs, carried across
  by ``convert.from_blocks`` (each field within rtol 1e-12 plus 1e-15 of
  its largest entry; a state out of a solve within rtol 1e-10 plus 1e-11
  of its largest entry, as each package factors with its own LU, and a
  coupled residual at a solved state within 1e-12 of the state's scale;
  the
  dense block derivatives within 1e-13 of each block's largest entry, as
  the two packages sum each entry's element contributions in their own
  order);
- the canonical explicit-FSI drive (the reference's stateful API: set
  the properties and controls, then ``solve_state1`` / ``set_ini_state``
  each step) in both packages, 5 steps, the same state.
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu.misc.taylor import taylor_convergence
from vf_fem_tpu_torch import convert
from vf_fem_tpu_torch.equations import newmark
from vf_fem_tpu_torch.models.dynamical import to_mono

from fixture_models import make_unit_solid_model
from port_fixtures import jax_vf_model, port_fsai_model, port_vf_model


def port_unit_solid_model(nx=4, ny=4):
    """The port's counterpart of ``fixture_models.make_unit_solid_model``."""
    from vf_fem_tpu_torch.load import load_solid_model
    from vf_fem_tpu_torch.mesh import mark_unit_mesh_fixtures, unit_square_mesh
    from vf_fem_tpu_torch.residuals import solid as slr

    model = load_solid_model(mark_unit_mesh_fixtures(unit_square_mesh(nx, ny)),
                             slr.KelvinVoigt, device="cpu", dtype=torch.float64)
    for k, v in dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, ycontact=10.0,
                     kcontact=1e8).items():
        if k in model.prop:
            model.prop[k][:] = v
    model.set_prop(model.prop)
    return model


def _seeded(model, rng):
    """The JAX fixture's state0, state1 and control draws (the same
    sequence of ``rng``) set on ``model``, a dict of the three."""
    vecs = {}
    for name, scale, draw in (("state0", 1e-4, "normal"), ("state1", 1e-4, "normal"),
                              ("control", 500.0, "random")):
        vec = getattr(model, name)
        n = sum(v.size for v in vec.values())
        x = scale * (rng.standard_normal(n) if draw == "normal" else rng.random(n))
        vecs[name] = _unflat(vec, x)
    model.dt = 1e-4
    model.set_ini_state(vecs["state0"])
    model.set_fin_state(vecs["state1"])
    model.set_control(vecs["control"])
    return vecs


def _flat(d) -> np.ndarray:
    return np.concatenate([np.asarray(v).reshape(-1) for v in d.values()])


def _unflat(like: dict, x) -> dict:
    out, i = {}, 0
    for k, v in like.items():
        out[k] = np.asarray(x[i:i + v.size], dtype=float).reshape(v.shape)
        i += v.size
    return out


@pytest.fixture(scope="module")
def model():
    """tests/test_transient_api.py's fixture on the port."""
    m = port_unit_solid_model()
    _seeded(m, np.random.default_rng(0))
    return m


@pytest.fixture(scope="module")
def solids():
    """The JAX fixture model and the port's, the port's vectors carried
    over from the JAX model's."""
    from test_transient_api import model as jax_fixture

    jm = jax_fixture.__wrapped__()
    tm = port_unit_solid_model()
    tm.set_prop(jm.prop)
    tm.set_ini_state(jm.state0)
    tm.set_fin_state(jm.state1)
    tm.set_control(jm.control_to_dict(jm.control))
    tm.dt = jm.dt
    return jm, tm


def _mono_res(model):
    return _flat(model.assem_res())


def _taylor(model, name, assem, rng, scale):
    x0 = _flat(getattr(model, name))
    dx = scale * rng.standard_normal(x0.size)
    setter = {"state1": model.set_fin_state, "state0": model.set_ini_state,
              "control": model.set_control}[name]
    like = getattr(model, name)

    def f(x):
        setter(_unflat(like, x))
        return _mono_res(model)

    def jac(x, d):
        setter(_unflat(like, x))
        return to_mono(assem()).numpy() @ d

    try:
        errors, rates = taylor_convergence(x0, dx, f, jac)
    finally:
        setter(_unflat(like, x0))
    return rates


def test_dres_dstate1_taylor(model):
    _taylor(model, "state1", model.assem_dres_dstate1, np.random.default_rng(1), 1e-5)


def test_dres_dstate0_taylor(model):
    _taylor(model, "state0", model.assem_dres_dstate0, np.random.default_rng(2), 1e-5)


def test_dres_dcontrol_taylor(model):
    _taylor(model, "control", model.assem_dres_dcontrol, np.random.default_rng(3), 1.0)


def test_solve_dres_dstate1_roundtrip(model):
    """solve_dres_dstate1 inverts the block Jacobian's action; the adjoint
    solve satisfies the duality (tests/test_transient_api.py:98-119)."""
    rng = np.random.default_rng(4)
    A = model.assem_dres_dstate1()
    b = _unflat(model.state1, rng.standard_normal(_flat(model.state1).size))
    x = model.solve_dres_dstate1(A, model.state1, b)
    Ax = to_mono(A).numpy() @ _flat(x)
    np.testing.assert_allclose(Ax, _flat(b), rtol=1e-6, atol=1e-8)
    b2 = _unflat(model.state1, rng.standard_normal(_flat(model.state1).size))
    x2 = model.solve_dres_dstate1_adj(A, model.state1, b2)
    np.testing.assert_allclose(float(np.dot(_flat(b2), _flat(x))),
                               float(np.dot(_flat(x2), _flat(b))), rtol=1e-9)


def test_cg_newton_matches_dense(model):
    """Matrix-free Newton-Krylov (EBE + BiCGStab) reproduces the dense-LU
    solve."""
    s_dense, _ = model.solve_state1(model.state0)
    s_cg, info_c = model.solve_state1(
        model.state0, options={"linear_solver": "cg", "krylov_tolerance": 1e-12})
    assert info_c["abs_err"] < 1e-6
    np.testing.assert_allclose(_flat(s_cg), _flat(s_dense), rtol=1e-6, atol=1e-10)


def test_fixed_iteration_newton_matches_adaptive(model):
    s_adapt, _ = model.solve_state1(model.state0)
    s_fixed, info_f = model.solve_state1(model.state0, options={"fixed_iterations": 4})
    np.testing.assert_allclose(_flat(s_fixed), _flat(s_adapt), rtol=1e-8, atol=1e-12)
    assert info_f["num_iter"] == 4


def test_fixed_tail_free_newton_bit_identical_iterates():
    """'fixed_tail_residual=False' on a strictly contracting chord: the
    committed iterate is the certified solve's bit for bit and the
    reported error the penultimate iterate's."""
    from vf_fem_tpu_torch.solvers.newton import newton_solve

    rng = np.random.default_rng(7)
    n = 40
    K = torch.as_tensor(np.diag(2.0 + rng.random(n)) + 0.1 * rng.standard_normal((n, n)))
    b = torch.as_tensor(rng.standard_normal(n))
    Kinv = torch.linalg.inv(K)

    def assem_res(x):
        return K @ x + 0.05 * x**3 - b

    def solve_jac(x, r):
        return Kinv @ r

    x0 = torch.zeros(n, dtype=torch.float64)
    x_tail, info_t = newton_solve(x0, assem_res, solve_jac, {"fixed_iterations": 3})
    x_free, info_f = newton_solve(x0, assem_res, solve_jac,
                                  {"fixed_iterations": 3, "fixed_tail_residual": False})
    assert torch.equal(x_free, x_tail)
    assert int(info_f.num_iter) == 3
    assert float(info_f.abs_err) >= float(info_t.abs_err)
    assert np.isfinite(float(info_f.abs_err))


def test_fixed_tail_free_model_step_matches_to_noise_floor(model):
    s_tail, _ = model.solve_state1(model.state0, options={"fixed_iterations": 3})
    s_free, info_f = model.solve_state1(
        model.state0, options={"fixed_iterations": 3, "fixed_tail_residual": False})
    np.testing.assert_allclose(_flat(s_free), _flat(s_tail), rtol=1e-6, atol=1e-9)
    assert info_f["num_iter"] == 3
    assert np.isfinite(info_f["abs_err"])


# -- each method against the JAX model's ---------------------------------------------

def assert_fields_close(port: dict, ref, rtol=1e-12, rel_atol=1e-15):
    """Every field of ``ref`` (a dict or a BlockVector) within ``rtol``
    plus ``rel_atol`` of the field's largest entry."""
    ref = convert.from_blocks(ref) if hasattr(ref, "sub_items") else ref
    assert list(port) == list(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(port[k]), r, rtol=rtol,
                                   atol=rel_atol * np.abs(r).max(), err_msg=k)


# a state out of a solve: each package factors with its own LU, so Newton's
# last iterate differs by rounding, up to 1.8e-12 of the field's largest
# entry in v (which carries u's rounding times 2/dt)
SOLVED = dict(rtol=1e-10, rel_atol=1e-11)


def assert_res_close(port: dict, ref, state1):
    """A residual at ``state1``: each field within rtol 1e-9 plus 1e-12 of
    the larger of its own and ``state1``'s field's largest entry (a block
    at a solved state is rounding of the state's scale)."""
    ref = convert.from_blocks(ref) if hasattr(ref, "sub_items") else ref
    state1 = convert.from_blocks(state1) if hasattr(state1, "sub_items") else state1
    assert list(port) == list(ref)
    for k, r in ref.items():
        scale = max(np.abs(r).max(), np.abs(np.asarray(state1[k])).max())
        np.testing.assert_allclose(port[k], r, rtol=1e-9, atol=1e-12 * scale, err_msg=k)


def assert_blocks_close(port: dict, ref: dict, rel=1e-13):
    """Each block within ``rel`` of its largest entry."""
    assert list(port) == list(ref)
    for key, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(port[key].numpy(), r, rtol=0,
                                   atol=rel * max(np.abs(r).max(), 1e-300), err_msg=str(key))


def _jax_blocks(bm, labels):
    """A JAX BlockMatrix as ``{(row, col): array}`` under the port's
    labels (the solid's control 'p' is the port's 'p1')."""
    rows, cols = labels
    return {(r, c): np.asarray(bm[jr, jc]) for r, jr in zip(rows, bm.labels[0])
            for c, jc in zip(cols, bm.labels[1])}


def test_solid_residual_and_state_match_jax(solids):
    jm, tm = solids
    assert_fields_close(tm.assem_res(), jm.assem_res())
    np.testing.assert_array_equal(tm.XREF, np.asarray(jm.XREF))
    assert tm.solid is tm and tm.dt == jm.dt
    for k, v in tm.prop.items():
        np.testing.assert_array_equal(v, np.asarray(jm.prop[k]))


@pytest.mark.parametrize("which", ["dstate1", "dstate0", "dcontrol"])
def test_solid_block_derivatives_match_jax(solids, which):
    jm, tm = solids
    uva = ("u", "v", "a")
    port = getattr(tm, f"assem_dres_{which}")()
    ref = _jax_blocks(getattr(jm, f"assem_dres_{which}")(),
                      (uva, ("p1",) if which == "dcontrol" else uva))
    assert_blocks_close(port, ref)


def test_solid_structured_solves_match_jax(solids):
    jm, tm = solids
    rng = np.random.default_rng(11)
    b = jm.state1.copy()
    b[:] = rng.standard_normal(b.size)
    A_j, A_t = jm.assem_dres_dstate1(), tm.assem_dres_dstate1()
    for name in ("solve_dres_dstate1", "solve_dres_dstate1_adj"):
        x_t = getattr(tm, name)(A_t, tm.state1, b)
        x_j = getattr(jm, name)(A_j, jm.state1.copy(), b)
        assert_fields_close(x_t, x_j, **SOLVED)


@pytest.mark.parametrize("options", [None, {"linear_solver": "cg", "krylov_tolerance": 1e-12},
                                     {"fixed_iterations": 3}])
def test_solid_solve_state1_matches_jax(solids, options):
    jm, tm = solids
    s_t, info_t = tm.solve_state1(tm.state0, options)
    s_j, info_j = jm.solve_state1(jm.state0.copy(), options)
    assert_fields_close(s_t, s_j, **SOLVED)
    assert info_t["num_iter"] == info_j["num_iter"]
    assert set(info_t) == set(info_j)


def test_solid_given_guess_starts_newton(solids):
    """``initial_guess='given'`` starts Newton from ``state1``: from the
    converged state it takes no iteration."""
    _, tm = solids
    s1, _ = tm.solve_state1(tm.state0)
    s2, info = tm.solve_state1(s1, {"initial_guess": "given"})
    assert info["num_iter"] == 0
    assert_fields_close(s2, s1, rtol=0, rel_atol=0)


def test_set_copies_into_the_models_arrays(solids):
    """``set_*`` copy key by key into the model's own arrays (a dict of
    numpy arrays or tensors, or a BlockVector), so the reference's idiom
    ``m.prop['emod'][:] = x; m.set_prop(m.prop)`` works, and a missing
    key raises."""
    _, tm = solids
    emod = tm.prop["emod"]
    old = emod.copy()
    try:
        tm.prop["emod"][:] = 4e4
        tm.set_prop(tm.prop)
        assert tm.prop["emod"] is emod and np.all(emod == 4e4)
        tm.set_prop({**tm.prop, "emod": torch.full((emod.size,), 3e4)})
        assert tm.prop["emod"] is emod and np.all(emod == 3e4)
        with pytest.raises(KeyError):
            tm.set_prop({"emod": old})
    finally:
        emod[:] = old


@pytest.fixture(scope="module")
def fsi_pairs():
    """The explicit (BernoulliAreaRatioSep) and implicit
    (BernoulliSmoothMinSep) 8 x 4 FSI models in both packages."""
    out = {}
    for coupling, fluid in (("explicit", "BernoulliAreaRatioSep"),
                            ("implicit", "BernoulliSmoothMinSep")):
        kw = dict(nx=8, ny=4, fluid=fluid, coupling=coupling)
        jm, tm = jax_vf_model(**kw), port_vf_model(**kw)
        tm.set_prop(jm.prop)
        tm.set_control(jm.control)
        for m in (jm, tm):
            m.dt = 1e-4
        out[coupling] = (jm, tm)
    return out


@pytest.mark.parametrize("coupling", ["explicit", "implicit"])
def test_fsi_stateful_steps_match_jax(fsi_pairs, coupling):
    """Three stateful steps (``solve_state1`` then ``set_ini_state``), then
    ``assem_res`` at the last step's state, in both packages."""
    jm, tm = fsi_pairs[coupling]
    jm.set_ini_state(jm.state0.copy() * 0.0)
    tm.set_ini_state({k: np.zeros_like(v) for k, v in tm.state0.items()})
    for _ in range(3):
        s_j, info_j = jm.solve_state1(jm.state0.copy())
        s_t, info_t = tm.solve_state1(tm.state0)
        assert_fields_close(s_t, s_j, **SOLVED)
        assert info_t["num_iter"] == info_j["num_iter"]
        jm.set_ini_state(s_j)
        tm.set_ini_state(s_t)
    # the residual of the JAX run's last state against 0.9 x itself
    scaled = jm.state0.copy()
    scaled[:] = 0.9 * scaled.to_mono_ndarray()
    for m in (jm, tm):
        m.set_fin_state(s_j)
        m.set_ini_state(scaled)
    assert_res_close(tm.assem_res(), jm.assem_res(), jm.state1)


def test_fsi_dt_and_prop_propagate(fsi_pairs):
    """``dt`` sets the solid's and the fluid's; ``set_prop`` each
    submodel's properties."""
    _, tm = fsi_pairs["explicit"]
    tm.dt = 2e-4
    assert tm.solid.dt == tm.fluid.dt == tm.dt == 2e-4
    tm.dt = 1e-4
    old = tm.prop["eta"].copy()
    try:
        tm.prop["eta"][:] = 2.5
        tm.prop["rho_air"][:] = 1.2e-3
        tm.set_prop(tm.prop)
        assert np.all(tm.solid.prop["eta"] == 2.5)
        assert np.all(tm.fluid.prop["rho_air"] == 1.2e-3)
    finally:
        tm.prop["eta"][:] = old
        tm.prop["rho_air"][:] = 1.1225e-3
        tm.set_prop(tm.prop)


def test_fluid_model_matches_jax(fsi_pairs):
    jm, tm = fsi_pairs["explicit"]
    jf, tf = jm.fluid, tm.fluid
    rng = np.random.default_rng(5)
    tf.set_prop(jf.prop)
    control = jf.control.copy()
    control[:] = np.abs(rng.standard_normal(control.size)) * 0.1
    control["psub"][:] = 8000.0
    jf.set_control(control)
    tf.set_control(control)
    s_j, info_j = jf.solve_state1(jf.state1.copy())
    s_t, info_t = tf.solve_state1(tf.state1)
    assert_fields_close(s_t, s_j)
    assert info_t == info_j == {}
    state1 = jf.state1.copy()
    state1[:] = rng.standard_normal(state1.size)
    jf.set_fin_state(state1)
    tf.set_fin_state(state1)
    assert_fields_close(tf.assem_res(), jf.assem_res())
    assert tf.fluid is tf


@pytest.fixture(scope="module")
def fsai_pair():
    from test_fsai import make_fsai_model

    jm = make_fsai_model(nx=8, ny=4)
    return jm, port_fsai_model(jm, nx=8, ny=4)


def test_fsai_stateful_steps_match_jax(fsai_pair):
    jm, tm = fsai_pair
    assert tm.dt == jm.dt
    tm.dt = jm.dt  # locked: the tract's own value passes
    with pytest.raises(ValueError):
        tm.dt = 2 * jm.dt
    for _ in range(2):
        s_j, info_j = jm.solve_state1(jm.state0.copy())
        s_t, info_t = tm.solve_state1(tm.state0)
        assert_fields_close(s_t, s_j, **SOLVED)
        assert info_t["num_iter"] == info_j["num_iter"]
        jm.set_ini_state(s_j)
        tm.set_ini_state(s_t)
    for m in (jm, tm):
        m.set_fin_state(s_j)
    assert_res_close(tm.assem_res(), jm.assem_res(), jm.state1)


def test_fsai_set_prop_propagates(fsai_pair):
    _, tm = fsai_pair
    old = tm.prop["proploss"].copy(), tm.prop["eta"].copy()
    try:
        tm.prop["proploss"][:] = 0.99
        tm.prop["eta"][:] = 2.0
        tm.set_prop(tm.prop)
        assert np.all(tm.acoustic.prop["proploss"] == 0.99)
        assert np.all(tm.fsi.prop["eta"] == 2.0) and np.all(tm.solid.prop["eta"] == 2.0)
    finally:
        tm.prop["proploss"][:], tm.prop["eta"][:] = old
        tm.set_prop(tm.prop)


def test_wra_stateful_api_matches_jax():
    from vf_fem_tpu.models import acoustic as jac
    from vf_fem_tpu_torch.models import acoustic as ac

    rng = np.random.default_rng(6)
    jm, tm = jac.WRAnalog(num_tube=12), ac.WRAnalog(num_tube=12, device="cpu")
    prop = jm.prop.copy()
    prop["area"][:] = 1.0 + rng.random(12)
    prop["proploss"][:] = 0.98
    state0 = jm.state0.copy()
    state0[:] = rng.standard_normal(state0.size)
    control = jm.control.copy()
    control[:] = 10.0
    for m in (jm, tm):
        m.set_prop(prop)
        m.set_ini_state(state0)
        m.set_control(control)
        m.set_fin_state(state0)
        with pytest.raises(NotImplementedError):
            m.dt = 1e-5
    assert tm.dt == jm.dt
    s_j, _ = jm.solve_state1()
    s_t, info = tm.solve_state1()
    assert info == {}
    assert_fields_close(s_t, s_j)
    assert_fields_close(tm.assem_res(), jm.assem_res(), rtol=1e-12, rel_atol=1e-14)


def test_newmark_hand_derivatives_match_jax():
    from vf_fem_tpu.equations import newmark as jnm

    rng = np.random.default_rng(8)
    u, u0, v0, a0, a1 = rng.standard_normal((5, 7))
    for dt in (1e-4, 2.5e-5):
        for name in ("v_du1", "v_du0", "v_dv0", "v_da0", "a_du1", "a_du0", "a_dv0", "a_da0"):
            assert getattr(newmark, f"newmark_{name}")(dt) == getattr(jnm, f"newmark_{name}")(dt)
        for name in ("v_dt", "a_dt"):
            np.testing.assert_array_equal(getattr(newmark, f"newmark_{name}")(u, u0, v0, a0, dt),
                                          getattr(jnm, f"newmark_{name}")(u, u0, v0, a0, dt))
        np.testing.assert_array_equal(newmark.newmark_error_estimate(a1, a0, dt),
                                      jnm.newmark_error_estimate(a1, a0, dt))


def test_canonical_drive_matches_jax():
    """The canonical explicit-FSI drive in both packages (only the imports
    and ``device='cpu'`` differ): 5 steps, the same state."""
    from vf_fem_tpu.load import load_fsi_model as jload
    from vf_fem_tpu.mesh import vocal_fold_mesh as jmesh
    from vf_fem_tpu.residuals import fluid as jflr, solid as jslr
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    def drive(load, mesh_fn, slr, flr, **kw):
        mesh = mesh_fn(12, 6)
        ymax = mesh.coords[:, 1].max()
        m = load(mesh, slr.KelvinVoigt, flr.BernoulliAreaRatioSep, coupling="explicit", **kw)
        m.prop["emod"][:] = 5e4; m.prop["rho"][:] = 1.0; m.prop["eta"][:] = 3.0
        m.prop["ycontact"][:] = ymax + 0.05; m.prop["kcontact"][:] = 1e8
        m.prop["rho_air"][:] = 1.1225e-3; m.prop["r_sep"][:] = 1.0
        m.prop["area_lb"][:] = 1e-5; m.prop["ymid"][:] = ymax + 0.01
        m.set_prop(m.prop)
        m.control["psub"][:] = 8000.0; m.control["psup"][:] = 0.0
        m.set_control(m.control)
        m.dt = 1e-4
        state = m.state0.copy()
        for n in range(5):
            state, info = m.solve_state1(state)
            m.set_ini_state(state)
        return state, info

    s_j, info_j = drive(jload, jmesh, jslr, jflr)
    s_t, info_t = drive(load_fsi_model, vocal_fold_mesh, slr, flr, device="cpu")
    assert_fields_close(s_t, s_j, **SOLVED)
    assert info_t["num_iter"] == info_j["num_iter"]
    assert info_t["abs_err"] < 1e-8
