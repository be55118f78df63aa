"""Shared model constructors for the PyTorch-port tests: the same model,
properties and controls in the JAX package and in the port, from the same
numpy inputs."""

import os

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(__file__), "..")
MESHES = os.path.join(REPO, "meshes")

# bench.py / tests/test_golden.py properties of the M5 benchmark model
M5_PROPS = dict(
    emod=5e4, rho=1.0, eta=3.0, nu=0.45, emod_membrane=0.0,
    nu_membrane=0.3, th_membrane=0.0, kcontact=1e8, rho_air=1.1225e-3,
    r_sep=1.0, area_lb=1e-4,
)

# the headline solver settings of bench.py, scaled down so that a short
# run takes every refresh branch (keep, full, Newton-Schulz, remainder)
HEADLINE_SMALL = {
    "jacobian_update": "once_per_step",
    "stagnation_ratio": 0.5,
    "jacobian_refresh_steps": 5,
    "jacobian_refresh_mode": "ns",
    "jacobian_full_refresh_windows": 2,
    "fixed_iterations": 2,
}


def assert_scatter_close(out, ref, bound, rtol):
    """A scatter against another summation order of itself: each entry
    within ``rtol`` or within the summation-order ``bound``
    (``fem.banded.scatter_order_bound``)."""
    out, ref, bound = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                       for x in (out, ref, bound))
    excess = np.abs(out - ref) - (rtol * np.abs(ref) + bound)
    assert (excess <= 0).all(), (
        f"{int((excess > 0).sum())} entries off; worst |diff| "
        f"{np.abs(out - ref).max():.3e}"
    )


def newmark_gap(du, dv0, da0, dt):
    """The gaps in v and a that gaps ``du`` in u (rows 0 .. M, row 0 the
    start) leave through the Newmark relations over a constant ``dt``,
    from gaps ``dv0``, ``da0`` at the start: rows 0 .. M, in float64."""
    from vf_fem_tpu_torch.equations import newmark

    k = newmark.coefficients(dt)
    dv, da = np.zeros_like(du), np.zeros_like(du)
    dv[0], da[0] = dv0, da0
    for n in range(1, len(du)):
        dv[n] = newmark.velocity_k(du[n], du[n - 1], dv[n - 1], da[n - 1], k)
        da[n] = newmark.acceleration_k(du[n], du[n - 1], dv[n - 1], da[n - 1], k)
    return {"v": dv, "a": da}


def set_props(prop, control, ymax, props=M5_PROPS, area_lb=None):
    """Fill a model's props/controls in place (BlockVector or dict)."""
    for k, v in props.items():
        if k in prop:
            prop[k][:] = v
    if area_lb is not None and "area_lb" in prop:
        prop["area_lb"][:] = area_lb
    # the smoothing widths of BernoulliSmoothMinSep (tests/fixture_models.py:42-45)
    for k in ("zeta_min", "zeta_sep"):
        if k in prop:
            prop[k][:] = 1e-3
    prop["ycontact"][:] = ymax + 0.05
    prop["ymid"][:] = ymax + 0.01
    control["psub"][:] = 8000.0
    control["psup"][:] = 0.0


def jax_vf_model(solid="KelvinVoigt", nx=12, ny=6, reorder=None,
                 fluid="BernoulliAreaRatioSep", coupling="explicit"):
    """JAX model of tests/fixture_models.make_vf_fsi_model (``reorder='rcm'``
    renumbers the mesh for the block-banded solver)."""
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.mesh import vocal_fold_mesh
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    model = load_fsi_model(
        vocal_fold_mesh(nx, ny), getattr(slr, solid),
        getattr(flr, fluid), coupling=coupling, reorder=reorder,
    )
    mesh = model.solid.residual.mesh()
    set_props(model.prop, model.control, mesh.coords[:, 1].max(),
              area_lb=1e-5)
    model.set_prop(model.prop)
    model.set_control(model.control)
    return model


def port_vf_model(solid="KelvinVoigt", nx=12, ny=6, device="cpu",
                  dtype=torch.float64, reorder=None,
                  fluid="BernoulliAreaRatioSep", coupling="explicit"):
    """The port's counterpart of :func:`jax_vf_model`."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    model = load_fsi_model(
        vocal_fold_mesh(nx, ny), getattr(slr, solid),
        getattr(flr, fluid), coupling=coupling, device=device, dtype=dtype,
        reorder=reorder,
    )
    mesh = model.solid.residual.mesh()
    set_props(model.prop, model.control, mesh.coords[:, 1].max(),
              area_lb=1e-5)
    return model


def solid_args(jm, p1):
    """(state0, control, prop) of a JAX model's solid, as JAX arrays and as
    tensors: a zero state and a uniform surface pressure ``p1``."""
    import jax.numpy as jnp

    js = jm.solid
    prop = {k: np.asarray(v) for k, v in jm.prop.sub_items()
            if k in jm._solid_prop_keys}
    host = ({k: np.zeros(js.ndof) for k in ("u", "v", "a")},
            {"p1": np.full(js.nvert, p1)}, prop)
    to_j = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in host)
    to_t = tuple({k: torch.as_tensor(v) for k, v in d.items()} for d in host)
    return to_j, to_t


def jax_inputs(model):
    """(zero state0, stacked controls, prop) of a JAX model, as numpy."""
    from vf_fem_tpu import forward

    ini = model.state0.copy()
    ini[:] = 0.0
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    return state0, cs, model.prop_to_dict(model.prop)


def port_inputs(model):
    """(zero state0, stacked controls, prop) of a port model, as numpy."""
    state0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    cs = {k: v[None] for k, v in model.control.items()}
    return state0, cs, model.prop


def port_smooth_model(jm, device="cpu", dtype=torch.float64, coupling="explicit",
                      nx=8, ny=4):
    """The port's counterpart of ``tests/fixture_models.make_vf_fsi_model``
    with ``BernoulliSmoothMinSep`` on ``vocal_fold_mesh(nx, ny)`` (by
    default 8 x 4, the JAX package's differentiation default), with the JAX
    model ``jm``'s properties and controls."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    tm = load_fsi_model(vocal_fold_mesh(nx, ny), slr.KelvinVoigt,
                        flr.BernoulliSmoothMinSep, coupling=coupling,
                        device=device, dtype=dtype)
    for k in tm.prop:
        tm.prop[k][:] = np.asarray(jm.prop[k])
    for k in tm.control:
        tm.control[k][:] = np.asarray(jm.control[k])
    return tm


def run_both(jm, tm, times, params):
    """One run from rest of a JAX model ``jm`` and of the port's ``tm``
    (``forward.integrate_pure``): ``(jax, port)``, each a (trajectory,
    solver iterations) pair of numpy arrays."""
    from vf_fem_tpu import forward as jforward
    from vf_fem_tpu_torch import forward

    _, jt, ji = jforward.integrate_pure(jm, *jax_inputs(jm), times, params)
    _, pt, pi = forward.integrate_pure(tm, *port_inputs(tm), times, params)
    return (({k: np.asarray(v) for k, v in jt.items()}, np.asarray(ji.num_iter)),
            ({k: v.cpu().numpy() for k, v in pt.items()}, pi.num_iter.cpu().numpy()))


def assert_runs_match(jax_run, port_run, rtol):
    """Every field of the trajectory within ``rtol`` (atol 1e-12 of the
    field's largest entry) and the iterations equal step by step."""
    (jt, jn), (pt, pn) = jax_run, port_run
    assert set(pt) == set(jt)
    for k, ref in jt.items():
        np.testing.assert_allclose(pt[k], ref, rtol=rtol,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)
    np.testing.assert_array_equal(pn, jn)


def port_fsai_model(jm, nx=10, ny=5, device="cpu", dtype=torch.float64):
    """The port's counterpart of ``tests/test_fsai.make_fsai_model(nx, ny,
    num_tube)`` (KelvinVoigt + BernoulliSmoothMinSep on
    ``vocal_fold_mesh(nx, ny)``, a WRA tract of the JAX model's tubes), with
    the JAX model ``jm``'s properties and controls."""
    from vf_fem_tpu_torch.load import load_fsai_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    tm = load_fsai_model(vocal_fold_mesh(nx, ny), slr.KelvinVoigt,
                         flr.BernoulliSmoothMinSep, num_tube=jm.acoustic.num_tube,
                         device=device, dtype=dtype)
    for k in tm.prop:
        tm.prop[k][:] = np.asarray(jm.prop[k])
    for k in tm.control:
        tm.control[k][:] = np.asarray(jm.control[k])
    return tm


def port_m5_fsai_model(config, dtype=torch.float64, device="cpu"):
    """The M5 FSAI model that ``tests/make_golden_fsai.py`` ran, built by the
    port from the configuration stored in its golden (``config``, the
    decoded JSON)."""
    from vf_fem_tpu_torch.load import load_fsai_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    tm = load_fsai_model(os.path.join(REPO, config["mesh"]), getattr(slr, config["solid"]),
                         getattr(flr, config["fluid"]), num_tube=config["num_tube"],
                         device=device, dtype=dtype)
    ymax = tm.solid.residual.mesh().coords[:, 1].max()
    for k, v in config["props"].items():
        tm.prop[k][:] = v
    tm.prop["ycontact"][:] = ymax + config["ycontact_above_ymax"]
    tm.prop["ymid"][:] = ymax + config["ymid_above_ymax"]
    tm.prop["area"][:] = config["tract_area"]
    tm.prop["proploss"][:] = config["proploss"]
    tm.control["psub"][:] = config["psub"]
    return tm


def band_blocks(h, nblk, ndof, A, b=128):
    """The band blocks (nblk, 2h+1, b, b) of a (ndof, ndof) matrix (block
    row n, block column n + m - h): zero outside the band and in the rows
    and columns past ndof."""
    Ap = np.zeros((nblk * b, nblk * b), dtype=A.dtype)
    Ap[:ndof, :ndof] = A
    blocks = np.zeros((nblk, 2 * h + 1, b, b), dtype=A.dtype)
    for n in range(nblk):
        for m in range(2 * h + 1):
            c = n + m - h
            if 0 <= c < nblk:
                blocks[n, m] = Ap[n * b:(n + 1) * b, c * b:(c + 1) * b]
    return blocks


def complex_band_system(h, nblk, ndof, seed, b=128):
    """A seeded complex banded matrix of dof bandwidth h*b - 1 (diagonally
    dominant, rows and columns scaled over four decades) as ``(blocks, A,
    r)``: its band blocks, the dense matrix and a complex rhs."""
    rng = np.random.default_rng(seed)
    i, j = np.indices((ndof, ndof))
    A = np.where(np.abs(i - j) < h * b, rng.standard_normal((ndof, ndof))
                 + 1j * rng.standard_normal((ndof, ndof)), 0.0)
    A += np.diag(4.0 * h * b * (1.0 + rng.random(ndof)) * np.exp(1j * rng.random(ndof)))
    s = 10.0 ** rng.uniform(-2, 2, ndof)
    A = s[:, None] * A * s[None, :]
    r = rng.standard_normal(ndof) + 1j * rng.standard_normal(ndof)
    return band_blocks(h, nblk, ndof, A, b), A, r


def bare_plan(cls, h, nblk, ndof, b=128):
    """A block-banded plan (``cls``: either package's ``BSBPlan``) with no
    fill targets: what the band solvers and matvecs read."""
    z = np.zeros(0, np.int32)
    return cls(ndof=ndof, b=b, nblk=nblk, nb=2 * h + 1, h=h, tgt_idx=z,
               src_keep=np.zeros(0, bool), bc_dofs=z, diag_ones=z)


# tests/test_ddstep.py:_make_model's properties and controls
DD_PROPS = dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, kcontact=1e8,
                rho_air=1.1225e-3, zeta_min=1e-3, zeta_sep=1e-3)


def set_dd_props(prop, control, ymax):
    for k, v in DD_PROPS.items():
        prop[k][:] = v
    prop["ycontact"][:] = ymax + 0.05
    prop["ymid"][:] = ymax + 0.01
    control["psub"][:] = 8000.0
    control["psup"][:] = 0.0


def port_dd_model(nx=40, ny=20, device="cpu", dtype=torch.float64):
    """The port's counterpart of ``tests/test_ddstep._make_model``: the
    RCM-renumbered ``vocal_fold_mesh(nx, ny)``, KelvinVoigt +
    BernoulliSmoothMinSep, explicit coupling."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    mesh = rcm_mesh(vocal_fold_mesh(nx, ny))
    model = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                           coupling="explicit", device=device, dtype=dtype)
    set_dd_props(model.prop, model.control, mesh.coords[:, 1].max())
    return model
