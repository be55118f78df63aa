"""
The 2D half of the JAX package's fixture matrix (``tests/test_matrix.py``)
as cases that either package builds and runs from the same numpy inputs:
``tests/make_golden_physics.py`` runs them in the JAX package into
``tests/data/golden_physics_2d.npz``, ``tests/test_torch_matrix.py`` in
the port against that golden.

A package namespace comes from ``dynamical_cases.jax_pkg`` /
``port_pkg`` (``load``, ``mesh``, ``slr``, ``flr`` and the loaders'
keyword arguments).  Each case id names one configuration:

- ``solid/<Solid>``: ``test_solid_transient_step``, one step of the solid
  alone on the unit square (3 x 3) under a uniform surface pressure of
  1000 Ba;
- ``fsi/<Solid>-<Fluid>``: ``test_fsi_matrix``, three coupled steps at
  dt 2e-5 on ``vocal_fold_mesh(8, 4)`` at psub 5000 Ba;
- ``e2e/<Solid>-<Fluid>``: ``test_e2e_residual_matrix[2d]``, two coupled
  steps with a swelling volume of 1.02 where the solid has one, and
  qsub 30 for the flow-driven fluid.
"""

import numpy as np

SOLIDS = [
    "Rayleigh", "KelvinVoigt", "KelvinVoigtWShape", "KelvinVoigtWEpithelium",
    "IncompSwellingKelvinVoigt", "SwellingKelvinVoigt", "SwellingKelvinVoigtWEpithelium",
    "SwellingKelvinVoigtWEpitheliumNoShape",
    "SwellingPowerLawKelvinVoigtWEpitheliumNoShape", "Approximate3DKelvinVoigt",
]
FSI_SOLIDS = ["KelvinVoigt", "Rayleigh"]
FSI_FLUIDS = ["BernoulliFixedSep", "BernoulliSmoothMinSep", "BernoulliAreaRatioSep"]
E2E_SOLIDS = ["Rayleigh", "KelvinVoigt", "SwellingKelvinVoigt", "KelvinVoigtWEpithelium"]
E2E_FLUIDS = ["BernoulliSmoothMinSep", "BernoulliFixedSep", "BernoulliAreaRatioSep",
              "BernoulliFlowFixedSep"]

# tests/test_matrix.py:35-54
DEFAULT_PROPS = {
    "emod": 5e4, "rho": 1.0, "eta": 3.0, "nu": 0.45,
    "emod_membrane": 1e4, "nu_membrane": 0.3, "th_membrane": 0.01,
    "v_swelling": 1.0, "k_swelling": 1e4, "m_swelling": 0.0,
    "ycontact": 10.0, "kcontact": 1e8,
    "rayleigh_m": 1.0, "rayleigh_k": 1e-4,
    "u_ant": 0.0, "u_pos": 0.0, "length": 1.0, "muscle_stress": 0.0,
    "rho_air": 1.1225e-3, "r_sep": 1.0, "area_lb": 1e-5,
    "zeta_min": 1e-3, "zeta_sep": 1e-3,
}


def case_ids():
    return ([f"solid/{s}" for s in SOLIDS]
            + [f"fsi/{s}-{f}" for s in FSI_SOLIDS for f in FSI_FLUIDS]
            + [f"e2e/{s}-{f}" for s in E2E_SOLIDS for f in E2E_FLUIDS])


def _set(vec, key, value):
    """Set one block of a BlockVector (the JAX package) or of a dict of
    numpy arrays (the port)."""
    vec[key][:] = value


def set_props(model, mesh, swelling=None):
    prop = model.prop
    for key, val in DEFAULT_PROPS.items():
        if key in prop:
            _set(prop, key, val)
    if "ymid" in prop:
        _set(prop, "ymid", mesh.coords[:, 1].max() + 0.01)
    if swelling is not None and "v_swelling" in prop:
        _set(prop, "v_swelling", swelling)
    if hasattr(model, "set_prop"):
        model.set_prop(prop)


def build(pkg, case_id):
    """``(model, kind, times)`` of a case in package ``pkg``: ``kind`` is
    'solid' (one step at dt 1e-4 under ``control['p']`` / ``['p1']`` of
    1000 Ba) or 'fsi' (``times`` of a coupled run from rest)."""
    kind, names = case_id.split("/")
    if kind == "solid":
        mesh = pkg.mesh.mark_unit_mesh_fixtures(pkg.mesh.unit_square_mesh(3, 3))
        model = pkg.load.load_solid_model(mesh, getattr(pkg.slr, names), **pkg.kw)
        set_props(model, mesh)
        return model, "solid", None
    solid, fluid = names.split("-")
    mesh = pkg.mesh.vocal_fold_mesh(8, 4)
    fixed = {"fsi": ("BernoulliFixedSep",), "e2e": ("BernoulliFixedSep", "BernoulliFlowFixedSep")}
    kw = {"fluid_kwargs": {"idx_sep": 10 if kind == "fsi" else 5}} if fluid in fixed[kind] else {}
    model = pkg.load.load_fsi_model(mesh, getattr(pkg.slr, solid), getattr(pkg.flr, fluid),
                                    coupling="explicit", **kw, **pkg.kw)
    set_props(model, mesh, swelling=1.02 if kind == "e2e" else None)
    control = model.control
    if "psub" in control:
        _set(control, "psub", 5000.0)
    else:  # the flow-driven variant
        _set(control, "qsub", 30.0)
    _set(control, "psup", 0.0)
    if hasattr(model, "set_control"):
        model.set_control(control)
    n_steps = 3 if kind == "fsi" else 2
    return model, "fsi", 2e-5 * np.arange(n_steps + 1)
