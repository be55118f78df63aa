"""
The port's dynamical models (``vf_fem_tpu_torch.models.dynamical``) against
the JAX package's on the CPU in f64, from the same numpy inputs
(``tests/dynamical_cases.py``; the JAX package's results are
``tests/data/golden_dynamical.npz``, made by ``python
tests/make_golden_hopf.py --dynamical``, since its op-by-op assembly takes
minutes):

- the solid model on ``tests/test_dynamical.py:18-20``'s unit square (3 x
  3), with the contact plane far away and across the top row (the
  contact-traction chain rule of ``dFu/du``), and the shape residual
  (``prop/umesh``); the fluid models on 12 points (BernoulliSmoothMinSep
  and BernoulliAreaRatioSep); the coupled model on
  ``tests/test_dynamical.py:239-273``'s vocal-fold mesh (8 x 4); the
  linearized solid, fluids and coupled model;
- ``assem_res``, ``assem_dres_dstate``, ``_dstatet``, ``_dcontrol`` and
  ``_dprop`` (every property block: emod, umesh, ymid, rho_air among
  them) at rtol 1e-10, atol 1e-12 times the matrix's largest entry, and
  each block at rtol 1e-10, atol 1e-12 times its own largest entry, with
  the JAX package's block labels and order.  A block that holds only
  rounding (its largest entry at most 1e-12 times that of its row and
  column of blocks) takes atol 1e-12 times the largest entry of its row
  and column of blocks, the scale of the terms whose rounding it holds.
  A linearized model's block sums one part for each entry of its
  tangents; where a part holds only rounding (a second derivative that is
  analytically zero), its atol adds twice that part's largest entry in
  the port (each package rounds it);
- the linearized models' residual against the Jacobian action of the
  dynamical ones;
- ``assem_banded_state_blocks`` and ``assem_dresu_dp1_cols`` entry for
  entry, the banded blocks against the dense ones, and the coupled model's
  fluid area and solid pressure;
- the three ``model_type``s of each loader against the JAX package's
  classes, and an invalid one raising.
"""

import json
import os

import numpy as np
import pytest
import torch

import dynamical_cases as dc
from vf_fem_tpu_torch import load, ops
from vf_fem_tpu_torch.mesh import vocal_fold_mesh
from vf_fem_tpu_torch.models import dynamical as dyn
from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_dynamical.npz")
RTOL, ATOL = 1e-10, 1e-12
# a block (or a tangent part of one) whose largest entry is at most this
# times its row and column's holds only rounding
ROUNDING = 1e-12
TANGENTS = ("dstate", "dstatet", "dcontrol", "dprop")
CASES = (["solid_" + n for n in dc.SOLIDS] + ["solid_lin"]
         + [p + n for n in dc.FLUIDS for p in ("fluid_", "fluid_lin_")]
         + ["fsi", "fsi_lin", "fsi_lin_dcontrol"])
BANDED = ["solid_" + n for n in dc.SOLIDS] + ["fsi"]


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def models():
    return dc.cases(dc.port_pkg())


def close(got, ref, scale, what, rounding=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL * max(scale, 1e-300) + rounding, err_msg=what)


def tangent_parts(m, which):
    """A linearized model's ``assem_<which>`` with one entry of its tangents
    at a time, the others zero: the parts whose sum is the block."""
    saved = {t: {k: v.clone() for k, v in getattr(m, t).items()}
             for t in TANGENTS if hasattr(m, t)}
    zero = {t: {k: torch.zeros_like(v) for k, v in d.items()} for t, d in saved.items()}
    parts = []
    for t, d in saved.items():
        for k, v in d.items():
            if not bool(v.abs().max() > 0):
                continue
            for tt, z in zero.items():
                getattr(m, "set_" + tt)(z)
            getattr(m, "set_" + t)({**zero[t], k: v})
            parts.append(getattr(m, "assem_" + which)())
    for t, d in saved.items():
        getattr(m, "set_" + t)(d)
    return parts


@pytest.mark.parametrize("which", dc.ASSEMBLIES)
@pytest.mark.parametrize("case", CASES)
def test_assembly_matches_jax(golden, models, case, which):
    val = getattr(models[case], "assem_" + which)()
    ref = golden[f"{case}/{which}"]
    labels = json.loads(str(golden[f"{case}/{which}/labels"]))
    close(dyn.to_mono(val), ref, np.abs(ref).max(), f"{case} {which}")
    if which == "res":
        assert list(val) == labels[0]
        return
    rows, cols = labels
    assert list(dict.fromkeys(k[0] for k in val)) == rows
    assert list(dict.fromkeys(k[1] for k in val)) == cols
    parts = tangent_parts(models[case], which) if "_lin" in case else []
    r_end = np.cumsum([val[r, cols[0]].shape[0] for r in rows])
    c_end = np.cumsum([val[rows[0], c].shape[1] for c in cols])
    for i, r in enumerate(rows):
        rs = slice(r_end[i] - val[r, cols[0]].shape[0], r_end[i])
        for j, c in enumerate(cols):
            cs = slice(c_end[j] - val[rows[0], c].shape[1], c_end[j])
            line = max(np.abs(ref[rs]).max(), np.abs(ref[:, cs]).max())
            own = np.abs(ref[rs, cs]).max()
            what = f"{case} {which} {r} {c}"
            if own <= ROUNDING * line:
                close(val[r, c], ref[rs, cs], line, what)
                continue
            part_max = [float(p[r, c].abs().max()) for p in parts]
            noise = sum(x for x in part_max if x <= ROUNDING * line)
            close(val[r, c], ref[rs, cs], own, what, rounding=2.0 * noise)


@pytest.mark.parametrize("case", BANDED)
def test_banded_blocks_match_jax_and_dense(golden, models, case):
    m = models[case]
    solid = m.solid if case == "fsi" else m
    plan, K, D, M = solid.assem_banded_state_blocks()
    for got, name in ((K, "K"), (D, "D"), (M, "M")):
        ref = golden[f"{case}/{name}"]
        close(got, ref, np.abs(ref).max(), f"{case} {name}")
    # the banded blocks are the dense ones, with the Dirichlet rows of the
    # Hopf pencil (identity in K, zero in D and M)
    sd = solid.assem_dres_dstate()
    sdt = solid.assem_dres_dstatet()
    n = solid.ndof
    bc = solid.residual.bc_dofs
    eye = torch.eye(n, dtype=torch.float64)
    for blocks, dense, identity in ((K, sd["u", "u"], True), (D, sd["u", "v"], False),
                                    (M, sdt["u", "v"], False)):
        dense = dense.clone()
        dense[bc] = eye[bc] if identity else 0.0
        got = torch.stack([ops.bsb_matvec(plan, blocks, eye[:, j]) for j in range(n)], dim=1)
        close(got, dense.numpy(), dense.abs().max().item(), f"{case} banded vs dense")
    verts = golden[f"{case}/dp1_verts"]
    ref = golden[f"{case}/dp1_cols"]
    close(solid.assem_dresu_dp1_cols(verts), ref, np.abs(ref).max(), f"{case} dp1 cols")
    # the columns are those of the dense dFu/dp, Dirichlet rows zero
    dense = solid.assem_dres_dcontrol()["u", "p"][:, torch.as_tensor(verts)].clone()
    dense[bc] = 0.0
    close(solid.assem_dresu_dp1_cols(verts), dense.numpy(), dense.abs().max().item(),
          f"{case} dp1 cols vs dense")


def test_solid_contact_engaged(models):
    """The contact plane at 0.9 presses on the top vertices, at 10 on none."""
    for name, engaged in (("kv_free", False), ("kv_contact", True), ("shape", True)):
        tc = models["solid_" + name]._fields()["control/tcontact"]
        assert (float(tc.abs().max()) > 0.0) == engaged, name


def test_fsi_coupling(golden, models):
    m = models["fsi"]
    for got, key in ((m.fluid.control["area"], "fsi/area"), (m.solid.control["p"],
                                                            "fsi/solid_p")):
        close(got, golden[key], np.abs(golden[key]).max(), key)


def _action(m, vecs):
    """The Jacobian action ``sum_v dF/dv . dv`` of a dynamical model."""
    return sum(dyn.to_mono(getattr(m, "assem_dres_d" + v)()) @ dyn.to_mono(dv)
               for v, dv in vecs.items())


@pytest.mark.parametrize("case, nonlin, vecs", [
    ("solid_lin", dc.solid_case, ("state", "statet", "control")),
    ("fluid_lin_smooth", dc.fluid_case, ("state", "control", "prop")),
    ("fluid_lin_area_ratio", dc.fluid_case, ("state", "control", "prop")),
    ("fsi_lin", dc.fsi_case, ("state", "statet")),
    ("fsi_lin_dcontrol", dc.fsi_case, ("control",)),
])
def test_linearized_is_jacobian_action(models, case, nonlin, vecs):
    lin = models[case]
    pkg = dc.port_pkg()
    if case.startswith("solid"):
        m = nonlin(pkg, "kv_contact")
    elif case.startswith("fluid"):
        m = nonlin(pkg, case.split("fluid_lin_")[1])
    else:
        m = nonlin(pkg)
    expect = _action(m, {v: getattr(lin, "d" + v) for v in vecs})
    got = dyn.to_mono(lin.assem_res())
    close(got, expect.numpy(), expect.abs().max().item(), f"{case} Jacobian action")


@pytest.mark.parametrize("model_type", ["transient", "dynamical", "linearized_dynamical"])
def test_loaders_model_type(model_type):
    from vf_fem_tpu import load as jload
    from vf_fem_tpu.mesh import vocal_fold_mesh as jvf

    names = {"transient": ("SolidModel", "FluidModel", "ExplicitFSIModel"),
             "dynamical": ("SolidDynamicalModel", "FluidDynamicalModel",
                           "FSIDynamicalModel"),
             "linearized_dynamical": ("LinearizedSolidDynamicalModel",
                                      "LinearizedFluidDynamicalModel",
                                      "LinearizedFSIDynamicalModel")}[model_type]
    mesh = vocal_fold_mesh(4, 2)
    sm = load.load_solid_model(mesh, slr.KelvinVoigt, model_type=model_type, device="cpu")
    fm = load.load_fluid_model(np.linspace(0, 1, 5), flr.BernoulliSmoothMinSep,
                               model_type=model_type, device="cpu")
    cm = load.load_fsi_model(mesh, model_type=model_type, device="cpu")
    assert (type(sm).__name__, type(fm).__name__, type(cm).__name__) == names
    jm = jload.load_fsi_model(jvf(4, 2), model_type=model_type)
    assert type(cm).__name__ == type(jm).__name__
    if model_type != "transient":
        for vec in ("state", "statet", "control", "prop"):
            assert list(getattr(cm, vec)) == list(getattr(jm, vec).keys()), vec


def test_loaders_invalid_model_type():
    mesh = vocal_fold_mesh(4, 2)
    for fn, args in ((load.load_solid_model, (mesh, slr.KelvinVoigt)),
                     (load.load_fluid_model, (np.linspace(0, 1, 5), flr.BernoulliSmoothMinSep)),
                     (load.load_fsi_model, (mesh,))):
        with pytest.raises(ValueError, match="Invalid model type steady"):
            fn(*args, model_type="steady", device="cpu")
    with pytest.raises(ValueError, match="Invalid `coupling`"):
        load.load_fsi_model(mesh, coupling="monolithic", device="cpu")
    # a dynamical model takes no coupling, as in the JAX package
    assert isinstance(load.load_fsi_model(mesh, model_type="dynamical",
                                          coupling="monolithic", device="cpu"),
                      dyn.FSIDynamicalModel)
