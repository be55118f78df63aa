"""
The dynamical-model cases of ``tests/test_torch_dynamical.py`` and of
their golden (``tests/make_golden_hopf.py --dynamical``): the same models
and the same numpy inputs in the JAX package and in the port.

A case is built from a package namespace ``pkg`` (:func:`jax_pkg` or
:func:`port_pkg`): its ``load``, ``slr``, ``flr`` and ``mesh`` modules
and the keyword arguments its loaders take (``device='cpu'`` for the
port).  Each case returns its models with every vector set from a seeded
numpy generator.
"""

import types

import numpy as np

# the unit square of tests/test_dynamical.py:18-20, with the contact plane
# far away (no contact), across the top row (the traction's chain rule),
# and the shape residual (prop/umesh)
SOLIDS = {"kv_free": ("KelvinVoigt", 10.0), "kv_contact": ("KelvinVoigt", 0.9),
          "shape": ("KelvinVoigtWShape", 0.9)}
FLUIDS = {"smooth": "BernoulliSmoothMinSep", "area_ratio": "BernoulliAreaRatioSep"}
ASSEMBLIES = ("res", "dres_dstate", "dres_dstatet", "dres_dcontrol", "dres_dprop")
N_DP1_COLS = 5


def jax_pkg():
    from vf_fem_tpu import load, mesh
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    return types.SimpleNamespace(load=load, mesh=mesh, slr=slr, flr=flr, kw={})


def port_pkg():
    from vf_fem_tpu_torch import load, mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    return types.SimpleNamespace(load=load, mesh=mesh, slr=slr, flr=flr, kw={"device": "cpu"})


def _size(v) -> int:
    return int(v.numel()) if hasattr(v, "numel") else int(np.size(v))


def sizes(vec) -> dict:
    """{label: size} of a block vector (a BlockVector or a dict)."""
    return {k: _size(vec[k]) for k in vec.keys()}


def set_vec(model, name: str, values: dict):
    """Set the blocks ``values`` ({label: array or scalar}) of vector
    ``name`` of a model of either package."""
    cur = getattr(model, name)
    if isinstance(cur, dict):  # the port
        full = {k: np.array(np.broadcast_to(np.asarray(values[k], dtype=float), (_size(v),)))
                if k in values else v for k, v in cur.items()}
        getattr(model, "set_" + name)(full)
    else:
        b = cur.copy()
        for k, v in values.items():
            b[k][:] = v
        getattr(model, "set_" + name)(b)


def solid_case(pkg, name: str, model_type: str = "dynamical"):
    residual, ycontact = SOLIDS[name]
    mesh = pkg.mesh.mark_unit_mesh_fixtures(pkg.mesh.unit_square_mesh(3, 3))
    m = pkg.load.load_solid_model(mesh, getattr(pkg.slr, residual), model_type=model_type,
                                  **pkg.kw)
    rng = np.random.default_rng(0)
    props = {"emod": 1e4, "rho": 1.0, "eta": 3.0, "ycontact": ycontact, "kcontact": 1e6}
    set_vec(m, "prop", {k: v for k, v in props.items() if k in m.prop.keys()})
    if "umesh" in m.prop.keys():
        set_vec(m, "prop", {"umesh": 1e-2 * rng.standard_normal(_size(m.prop["umesh"]))})
    n = _size(m.state["u"])
    set_vec(m, "state", {"u": 1e-1 * rng.standard_normal(n), "v": 1e-2 * rng.standard_normal(n)})
    set_vec(m, "statet", {"u": 1e-2 * rng.standard_normal(n),
                          "v": 1e-2 * rng.standard_normal(n)})
    set_vec(m, "control", {"p": 100.0 * rng.random(_size(m.control["p"]))})
    if model_type == "linearized_dynamical":
        for vec in ("dstate", "dstatet", "dcontrol"):
            set_vec(m, vec, {k: rng.standard_normal(s) for k, s in sizes(getattr(m, vec)).items()})
    return m


def dp1_verts(nvert: int) -> np.ndarray:
    return np.sort(np.random.default_rng(1).choice(nvert, N_DP1_COLS, replace=False))


def fluid_case(pkg, name: str, model_type: str = "dynamical"):
    s = np.linspace(0, 1, 12)
    m = pkg.load.load_fluid_model(s, getattr(pkg.flr, FLUIDS[name]), model_type=model_type,
                                  **pkg.kw)
    rng = np.random.default_rng(3)
    set_vec(m, "control", {"area": 0.5 + 0.3 * rng.random(12), "psub": 8000.0, "psup": 0.0})
    props = {"rho_air": 1.1225e-3, "zeta_min": 1e-2, "zeta_sep": 1e-2, "r_sep": 1.2,
             "area_lb": 1e-4}
    set_vec(m, "prop", {k: v for k, v in props.items() if k in m.prop.keys()})
    set_vec(m, "state", {"q": 50.0, "p": 100.0 + rng.random(12)})
    if model_type == "linearized_dynamical":
        for vec in ("dstate", "dcontrol", "dprop"):
            set_vec(m, vec, {k: rng.standard_normal(s) for k, s in sizes(getattr(m, vec)).items()})
    return m


def fsi_case(pkg, model_type: str = "dynamical", dcontrol: bool = False):
    """tests/test_dynamical.py:239-273's coupled model (vocal-fold mesh 8 x
    4); the linearized one with state tangents, or with a control tangent
    only (``dcontrol``)."""
    mesh = pkg.mesh.vocal_fold_mesh(8, 4)
    m = pkg.load.load_fsi_model(mesh, pkg.slr.KelvinVoigt, pkg.flr.BernoulliSmoothMinSep,
                                model_type=model_type, **pkg.kw)
    ymax = mesh.coords[:, 1].max()
    set_vec(m, "prop", {"emod": 5e4, "rho": 1.0, "eta": 3.0, "ycontact": ymax + 0.05,
                        "rho_air": 1.1225e-3, "zeta_min": 1e-2, "zeta_sep": 1e-2,
                        "ymid": ymax + 0.01})
    set_vec(m, "control", {"psub": 8000.0, "psup": 0.0})
    rng = np.random.default_rng(5)
    n = _size(m.state["u"])
    set_vec(m, "state", {"u": 1e-3 * rng.standard_normal(n), "v": 1e-3 * rng.standard_normal(n),
                         "q": 50.0, "p": 100.0})
    set_vec(m, "statet", {k: 1e-3 * rng.standard_normal(s) for k, s in sizes(m.statet).items()})
    if model_type == "linearized_dynamical":
        if dcontrol:
            set_vec(m, "dcontrol", {k: rng.standard_normal(s)
                                    for k, s in sizes(m.dcontrol).items()})
        else:
            for vec in ("dstate", "dstatet"):
                set_vec(m, vec, {k: rng.standard_normal(s)
                                 for k, s in sizes(getattr(m, vec)).items()})
    return m


def cases(pkg):
    """{case name: model} of every case of the golden."""
    out = {}
    for name in SOLIDS:
        out["solid_" + name] = solid_case(pkg, name)
    out["solid_lin"] = solid_case(pkg, "kv_contact", "linearized_dynamical")
    for name in FLUIDS:
        out["fluid_" + name] = fluid_case(pkg, name)
        out["fluid_lin_" + name] = fluid_case(pkg, name, "linearized_dynamical")
    out["fsi"] = fsi_case(pkg)
    out["fsi_lin"] = fsi_case(pkg, "linearized_dynamical")
    out["fsi_lin_dcontrol"] = fsi_case(pkg, "linearized_dynamical", dcontrol=True)
    return out
