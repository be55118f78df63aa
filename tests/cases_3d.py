"""
The 3D cases of the JAX package's tests as cases that either package builds
and runs from the same numpy inputs: ``tests/make_golden_3d.py`` runs them
in the JAX package into ``tests/data/golden_3d.npz``,
``tests/test_torch_fsi_3d.py`` in the port against that golden.

A package namespace comes from ``dynamical_cases.jax_pkg`` / ``port_pkg``.
Each case id names one configuration:

- ``cube``: ``tests/test_fsi_3d.py::test_fsi_3d_steps``, KelvinVoigt +
  BernoulliSmoothMinSep on the marked unit cube (3 x 3 x 2), one fluid
  channel on each of 3 z-planes, 4 coupled steps of 2e-5 s at psub 5000 Ba;
- ``m5x``: ``test_extruded_m5_3d_fsi``, the M5_CB_GA3 profile (h 0.08,
  8 smoothing passes) extruded through 3 planes over 1.5 cm, 3 steps of
  ``solve_state1`` at dt 1e-4 and psub 8000 Ba;
- ``e2e3d/<Solid>-<Fluid>``: ``tests/test_matrix.py::
  test_e2e_residual_matrix[...-3d]``, ``vocal_fold_mesh(6, 3)`` extruded
  through 3 planes over 0.4 cm, two coupled steps (a swelling volume of
  1.02 where the solid has one, qsub 30 for the flow-driven fluid);
- ``btd3d``: ``tests/test_bsb.py::test_btd_banded_3d_trajectory``, the
  small extruded stack of ``chip_smoke.py`` phase 17 (``EXTRUDED_SMALL``:
  its dense exact, btd and bf16-btd runs over 12 steps).
"""

import importlib

import numpy as np

import chip_smoke as cs
import physics_cases as pc

E2E_SOLIDS = pc.E2E_SOLIDS
E2E_FLUIDS = pc.E2E_FLUIDS
CUBE_PROPS = dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, ycontact=2.0, kcontact=1e8,
                  rho_air=1.1225e-3, zeta_min=1e-2, zeta_sep=1e-2, ymid=1.05)
M5X = dict(profile="M5_CB_GA3", h=0.08, smooth_iters=8, nz=3, zlen=1.5, n_steps=3, dt=1e-4)


def case_ids():
    return (["cube", "m5x"] + [f"e2e3d/{s}-{f}" for s in E2E_SOLIDS for f in E2E_FLUIDS])


def extrude(pkg, mesh2d, zs):
    return importlib.import_module(pkg.mesh.__name__ + ".extrude").extrude_mesh(mesh2d, zs)


def _set_all(model, props, controls):
    cs.set_values(model, props, controls)
    model.set_prop(model.prop)
    model.set_control(model.control)


def extruded_small_mesh(pkg):
    """``chip_smoke.EXTRUDED_SMALL``'s mesh (RCM-ordered) and planes."""
    c = cs.EXTRUDED_SMALL
    zs = np.linspace(0.0, c["zlen"], c["nz"])
    m2 = pkg.mesh.m5_mesh(c["profile"], h=c["h"], smooth_iters=c["smooth_iters"])
    reorder = importlib.import_module(pkg.mesh.__name__ + ".reorder")
    return reorder.rcm_mesh(extrude(pkg, m2, zs)), zs


def build(pkg, case_id):
    """``(model, zs, times)`` of a case: ``times`` of the coupled run from
    rest (``m5x``: None, it steps by ``solve_state1``)."""
    if case_id == "cube":
        zs = np.linspace(0, 1, 3)
        mesh = pkg.mesh.mark_unit_mesh_fixtures(pkg.mesh.unit_cube_mesh(3, 3, 2))
        model = pkg.load.load_fsi_model(mesh, pkg.slr.KelvinVoigt, pkg.flr.BernoulliSmoothMinSep,
                                        coupling="explicit", zs=zs, **pkg.kw)
        _set_all(model, CUBE_PROPS, {"psub": 5000.0, "psup": 0.0})
        return model, zs, 2e-5 * np.arange(5)
    if case_id == "m5x":
        zs = np.linspace(0.0, M5X["zlen"], M5X["nz"])
        mesh = extrude(pkg, pkg.mesh.m5_mesh(M5X["profile"], h=M5X["h"],
                                             smooth_iters=M5X["smooth_iters"]), zs)
        model = pkg.load.load_fsi_model(mesh, pkg.slr.KelvinVoigt, pkg.flr.BernoulliSmoothMinSep,
                                        coupling="explicit", zs=zs, **pkg.kw)
        ymax = mesh.coords[:, 1].max()
        _set_all(model, {**CUBE_PROPS, "ycontact": ymax + 0.05, "ymid": ymax + 0.01},
                 {"psub": 8000.0, "psup": 0.0})
        return model, zs, None
    if case_id == "btd3d":
        mesh, zs = extruded_small_mesh(pkg)
        c = cs.EXTRUDED_SMALL
        model = pkg.load.load_fsi_model(mesh, getattr(pkg.slr, c["solid"]),
                                        getattr(pkg.flr, c["fluid"]), coupling="explicit",
                                        zs=zs, **pkg.kw)
        _set_all(model, cs.extruded_small_values(mesh.coords[:, 1].max()),
                 {"psub": c["psub"], "psup": 0.0})
        return model, zs, c["dt"] * np.arange(c["n_steps"] + 1)
    solid, fluid = case_id.split("/")[1].split("-")
    zs = np.linspace(0.0, 0.4, 3)
    mesh = extrude(pkg, pkg.mesh.vocal_fold_mesh(6, 3), zs)
    kw = ({"fluid_kwargs": {"idx_sep": 5}}
          if fluid in ("BernoulliFixedSep", "BernoulliFlowFixedSep") else {})
    model = pkg.load.load_fsi_model(mesh, getattr(pkg.slr, solid), getattr(pkg.flr, fluid),
                                    coupling="explicit", zs=zs, **kw, **pkg.kw)
    pc.set_props(model, mesh, swelling=1.02)
    control = model.control
    if "psub" in control:
        pc._set(control, "psub", 5000.0)
    else:  # the flow-driven variant
        pc._set(control, "qsub", 30.0)
    pc._set(control, "psup", 0.0)
    model.set_control(control)
    return model, zs, 2e-5 * np.arange(3)
