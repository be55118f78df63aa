"""
Why ``chip_smoke.py``'s physics phase runs its models where it does: the
two M5 models of ``PHYSICS_M5`` in the JAX package on a CPU (f64, 100
steps at dt 1e-4, the headline solver settings on the plain assembly),
once in bench.py's configuration (its properties, psub 8000 Ba and glottal
gap: the midline 0.01 above the medial surface's peak and the contact
plane 0.04 beyond it; separation at the 'separation-sup' vertex, qsub 100
cm^2/s) and once in the phase's own
(``chip_smoke.physics_values``, ``PHYSICS_CONTROLS``,
``PHYSICS_SEPARATION``), and single changes between the two:

    python tests/probe_physics_config.py [--large]

With ``--large``, the phase's 23.7k swelling model (``PHYSICS_LARGE``) on
the production btd settings and their exact-Jacobian counterpart, f64, at
the phase's values (``PHYSICS_LARGE_PROPS``, ``PHYSICS_LARGE_CONTROLS``)
and with the M5 runs' swelling volume of 1.02 or a higher psub (about 15
minutes on an 8-core CPU).  Each line: the largest |u| over the run (cm), the largest Newton abs_err,
the uncertified steps and the first step whose state is not finite.  A
run whose |u| reaches centimetres on a fold about 1 cm deep has left the
glottis; the port's runs are the JAX package's to rounding (``tests/
test_torch_matrix.py::test_m5_physics_golden_prefix``), so this is a
property of the configuration.  Not collected by pytest; it imports jax,
so it is no part of the PyTorch port.
"""

import os
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
for p in (REPO, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

import chip_smoke as cs  # noqa: E402

BENCH = {"separation": "separation-sup", "ymid": 0.01, "ycontact": 0.05,
         "controls": {"psub": 8000.0, "qsub": 100.0, "psup": 0.0}}
PHASE = {"separation": cs.PHYSICS_SEPARATION, "ymid": cs.PHYSICS_YMID_ABOVE_YMAX,
         "ycontact": cs.PHYSICS_YCONTACT_ABOVE_YMAX, "controls": cs.PHYSICS_CONTROLS}


def variants():
    yield "bench.py's", BENCH
    yield "bench.py's, separation-inf", {**BENCH, "separation": "separation-inf"}
    yield "bench.py's, the phase's gap and contact plane", {
        **BENCH, "ymid": PHASE["ymid"], "ycontact": PHASE["ycontact"]}
    yield "the phase's, psub 8000", {**PHASE, "controls": {**PHASE["controls"], "psub": 8000.0}}
    yield "the phase's, separation-sup", {**PHASE, "separation": "separation-sup"}
    yield "the phase's", PHASE


LARGE_VARIANTS = (
    ("the phase's", {}, {}),
    ("swelling volume 1.02", {"v_swelling": 1.02}, {}),
    ("swelling volume 1.02, psub 500", {"v_swelling": 1.02}, {"psub": 500.0}),
    ("psub 1500", {}, {"psub": 1500.0}),
    ("psub 2000", {}, {"psub": 2000.0}),
)


def run(solid, fluid, v, mesh_name="M5_3layers.msh", props=None,
        params=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vf_fem_tpu import forward
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.mesh import load_gmsh, locate_separation_vertex
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    path = os.path.join(REPO, "meshes", mesh_name)
    probe = load_fsi_model(load_gmsh(path), slr.KelvinVoigt, flr.BernoulliAreaRatioSep)
    sdofs = np.asarray(probe._solid_dofs)
    mesh = probe.solid.residual.mesh()
    idx_sep = int(np.nonzero(sdofs == locate_separation_vertex(mesh, v["separation"]))[0][0])
    model = load_fsi_model(path, getattr(slr, solid), getattr(flr, fluid),
                           fluid_kwargs={"idx_sep": idx_sep})
    ymax = mesh.coords[:, 1].max()
    values = {**cs.bench_values(ymax), **(props or cs.PHYSICS_PROPS),
              "ymid": ymax + v["ymid"], "ycontact": ymax + v["ycontact"]}
    cs.set_values(model, values, v["controls"])
    model.set_prop(model.prop)
    model.set_control(model.control)
    ini = model.state0.copy()
    ini[:] = 0.0
    params = params or {**cs.HEADLINE, "assembly": "plain"}
    _, traj, infos = forward.integrate_pure(
        model, {k: np.asarray(x) for k, x in ini.sub_items()},
        forward._stack_controls(model, [model.control]), model.prop_to_dict(model.prop),
        cs.DT * np.arange(cs.N_STEPS + 1), params)
    u = np.asarray(traj["u"])
    finite = np.isfinite(u).all(axis=1)
    info = {k: np.asarray(getattr(infos, k)) for k in ("num_iter", "abs_err", "rel_err")}
    return (float(np.nanmax(np.abs(u))), float(np.nanmax(info["abs_err"])),
            forward.certify_fixed_iterations(params, info),
            None if finite.all() else int(np.argmin(finite)), idx_sep)


def main():
    import warnings

    warnings.filterwarnings("ignore")
    if "--large" in sys.argv:
        solid, fluid = cs.PHYSICS_LARGE
        for name, props, controls in LARGE_VARIANTS:
            v = {**PHASE, "controls": {**cs.PHYSICS_LARGE_CONTROLS, **controls}}
            for settings, params in (("production", cs.BTD_PROD), ("exact", cs.BTD_EXACT)):
                umax, err, unc, bad, idx = run(solid, fluid, v, cs.LARGE_MESH,
                                               {**cs.PHYSICS_LARGE_PROPS, **props}, params)
                print(f"23.7k {solid} + {fluid}, {name}, {settings} (idx_sep {idx}): max|u|"
                      f" {umax:.4e}, max abs_err {err:.3e}, uncertified {unc}, first"
                      f" non-finite step {bad}", flush=True)
        return
    for tag, (solid, fluid) in cs.PHYSICS_M5.items():
        for name, v in variants():
            umax, err, unc, bad, idx = run(solid, fluid, v)
            print(f"{solid} + {fluid}, {name} (idx_sep {idx}): max|u| {umax:.4e},"
                  f" max abs_err {err:.3e}, uncertified {unc}, first non-finite step {bad}",
                  flush=True)


if __name__ == "__main__":
    main()
