"""
Generate the goldens of the port's slice of 2D physics with the JAX
package on a CPU, in f64:

    python tests/make_golden_physics.py [--matrix] [--m5] [--large]

(all three without a flag).

- ``--matrix``: ``tests/data/golden_physics_2d.npz``, the 2D half of the
  JAX package's fixture matrix (``tests/physics_cases.py``: 10 solid
  steps, 2 x 3 coupled runs, 4 x 4 end-to-end runs).  For each case id the
  final state (``<id>|<key>``) and each step's Newton ``abs_err``
  (``<id>|abs_err``).  The JAX package's matrix takes 10-18 s a
  configuration, so ``tests/test_torch_matrix.py`` reads this golden
  rather than running it.
- ``--m5``: ``tests/data/golden_m5_physics.npz``, the M5 runs of
  ``chip_smoke.py``'s physics phase (``PHYSICS_M5``: its two models, 100
  steps at dt 1e-4, the headline solver settings on the plain assembly):
  per model every eighth u, all q and the final p, the Newton counts and
  the uncertified steps, with the configuration as JSON under ``config``.
- ``--large``: ``tests/data/golden_physics_23k.npz``, the phase's 23.7k
  model on the production btd settings and on their exact-Jacobian
  counterpart, in f64 and (a child process with ``VF_FEM_TPU_X64=0``, the
  JAX package's switch to float32) in f32: ``traj_err`` and
  ``f32_traj_err`` = max|u_prod - u_exact| / max|u_exact| of the final u,
  ``f32_vs_f64`` of the production runs' final u, the f64 production
  run's final u and the uncertified steps of each production run (about
  10 minutes on an 8-core CPU).

Not collected by pytest (its name does not start with ``test_``); it
imports jax, so it is no part of the PyTorch port.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DATA = os.path.join(TESTS, "data")
for p in (REPO, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

import chip_smoke as cs  # noqa: E402  (its PHYSICS_* configuration)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _jax_state(fin):
    return {k: np.asarray(v) for k, v in fin.sub_items()}


def run_matrix():
    _jax()
    import dynamical_cases
    import physics_cases as pc
    from vf_fem_tpu import forward

    pkg = dynamical_cases.jax_pkg()
    out = {}
    for cid in pc.case_ids():
        t0 = time.perf_counter()
        model, kind, times = pc.build(pkg, cid)
        if kind == "solid":
            model.control["p"][:] = 1000.0
            model.set_control(model.control)
            model.dt = 1e-4
            fin, info = model.solve_state1(model.state0)
            abs_err = np.array([info["abs_err"]])
        else:
            ini = model.state0.copy()
            ini[:] = 0.0
            fin, info = forward.integrate(model, None, ini, [model.control], model.prop,
                                          times, write=False)
            abs_err = np.asarray(info["all"]["abs_err"])
        for k, v in _jax_state(fin).items():
            out[f"{cid}|{k}"] = v
        out[f"{cid}|abs_err"] = abs_err
        print(f"{cid}: {time.perf_counter() - t0:.1f} s, max abs_err {abs_err.max():.3e}",
              flush=True)
    np.savez_compressed(os.path.join(DATA, "golden_physics_2d.npz"), **out)


def build_physics(mesh_name, solid, fluid):
    """A JAX model of the physics phase (``chip_smoke.physics_model``'s
    configuration) and its numpy inputs."""
    from vf_fem_tpu import forward
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.mesh import load_gmsh, locate_separation_vertex
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    path = os.path.join(REPO, "meshes", mesh_name)
    probe = load_fsi_model(load_gmsh(path), slr.KelvinVoigt, flr.BernoulliAreaRatioSep)
    sdofs = np.asarray(probe._solid_dofs)
    sep = locate_separation_vertex(probe.solid.residual.mesh(), cs.PHYSICS_SEPARATION)
    idx_sep = int(np.nonzero(sdofs == sep)[0][0])
    model = load_fsi_model(path, getattr(slr, solid), getattr(flr, fluid),
                           fluid_kwargs={"idx_sep": idx_sep})
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    cs.set_values(model, *cs.physics_values(ymax, mesh_name == cs.LARGE_MESH))
    model.set_prop(model.prop)
    model.set_control(model.control)
    ini = model.state0.copy()
    ini[:] = 0.0
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    inputs = (state0, forward._stack_controls(model, [model.control]),
              model.prop_to_dict(model.prop))
    return model, inputs, idx_sep


def run(model, inputs, params, n_steps):
    from vf_fem_tpu import forward

    t0 = time.perf_counter()
    fin, traj, infos = forward.integrate_pure(model, *inputs, cs.DT * np.arange(n_steps + 1),
                                              params)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    info = {k: np.asarray(getattr(infos, k)) for k in ("num_iter", "abs_err", "rel_err")}
    uncert = forward.certify_fixed_iterations(params, info)
    print(f"  {n_steps} steps in {time.perf_counter() - t0:.1f} s (host clock of this CPU),"
          f" max|u| {np.abs(traj['u']).max():.4e}, uncertified {uncert}", flush=True)
    return traj, info, uncert


def run_m5():
    _jax()
    out, config = {}, {}
    params = {**cs.HEADLINE, "assembly": "plain"}
    for tag, (solid, fluid) in cs.PHYSICS_M5.items():
        print(f"M5 {tag}: {solid} + {fluid}", flush=True)
        model, inputs, idx_sep = build_physics("M5_3layers.msh", solid, fluid)
        traj, info, uncert = run(model, inputs, params, cs.N_STEPS)
        out[f"{tag}|u"] = traj["u"][::8]
        out[f"{tag}|q"] = traj["q"].ravel()
        out[f"{tag}|p_final"] = traj["p"][-1]
        out[f"{tag}|num_iter"] = info["num_iter"]
        out[f"{tag}|uncertified"] = np.array(uncert)
        config[tag] = {"solid": solid, "fluid": fluid, "idx_sep": idx_sep}
    config.update(cs.physics_config())
    np.savez_compressed(os.path.join(DATA, "golden_m5_physics.npz"),
                        config=json.dumps(config, sort_keys=True), **out)


def large_runs():
    solid, fluid = cs.PHYSICS_LARGE
    model, inputs, idx_sep = build_physics(cs.LARGE_MESH, solid, fluid)
    print(f"23.7k {solid} + {fluid}: {model.solid.ndof} dofs, idx_sep {idx_sep}", flush=True)
    prod, prod_info, uncert = run(model, inputs, cs.BTD_PROD, cs.N_STEPS)
    exact, _, _ = run(model, inputs, cs.BTD_EXACT, cs.N_STEPS)
    return prod["u"][-1], exact["u"][-1], uncert, idx_sep


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def run_large():
    _jax()
    u, u_exact, uncert, idx_sep = large_runs()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f32.npz")
        print("f32 (child process):", flush=True)
        subprocess.run([sys.executable, __file__, "--f32-child", path],
                       env={**os.environ, "VF_FEM_TPU_X64": "0"}, check=True)
        f32 = dict(np.load(path))
    assert f32["u"].dtype == np.float32, f32["u"].dtype
    out = dict(traj_err=rel(u, u_exact), f32_traj_err=rel(f32["u"], f32["u_exact"]),
               f32_vs_f64=rel(f32["u"], u), u_final=u, uncertified=np.array(uncert),
               f32_uncertified=f32["uncertified"], idx_sep=np.array(idx_sep))
    print({k: v for k, v in out.items() if k != "u_final"}, flush=True)
    np.savez_compressed(os.path.join(DATA, "golden_physics_23k.npz"),
                        config=json.dumps(cs.physics_config(), sort_keys=True), **out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", action="store_true")
    ap.add_argument("--m5", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--f32-child", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.f32_child:
        _jax()
        u, u_exact, uncert, _ = large_runs()
        np.savez(args.f32_child, u=u, u_exact=u_exact, uncertified=np.array(uncert))
        return
    every = not (args.matrix or args.m5 or args.large)
    if args.matrix or every:
        run_matrix()
    if args.m5 or every:
        run_m5()
    if args.large or every:
        run_large()


if __name__ == "__main__":
    main()
