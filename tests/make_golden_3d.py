"""
Generate the goldens of the port's extruded-3D slice with the JAX package
on a CPU, in f64:

    python tests/make_golden_3d.py [--large]

- default: ``tests/data/golden_3d.npz``, the JAX package's 3D tests
  (``tests/cases_3d.py``), which take 12-50 s each and are not run live:
  the final state of ``cube``, ``m5x`` and the 16 ``e2e3d`` cases
  (``<id>|<key>``) with each step's Newton ``abs_err`` (``<id>|abs_err``),
  and the u and q trajectories of the three ``btd3d`` runs
  (``btd3d|<run>|u``, ``|q``; ``chip_smoke.EXTRUDED_SMALL_RUNS``), about
  5 minutes on an 8-core CPU.
- ``--large``: ``tests/data/golden_3d_45k.npz``, the 45.8k-dof fold of
  ``chip_smoke.py`` phase 17 (``MESH3D``), meshed by the JAX package's own
  ``m5_mesh``, ``extrude_mesh`` and ``rcm_mesh`` with its defaults (as
  ``benchmarks/benchmark_large.py``'s ``build_model`` meshes it) and held
  identical to the port's cached mesh (coords and cells bit for bit, the
  markers by ``mesh_digest``, which does not depend on the order the JAX
  native facet kernels give the facets) before the runs; its ``chip_smoke.mesh_digest``
  and coords are stored, and phase 17 holds the port's mesh on the card
  to them.  Then the first ``GOLDEN_3D_STEPS`` steps of the tight f64 btd
  run (``BTD_TIGHT``), every eighth u entry and all q, with the Newton
  counts; then the production runs (``BTD_PROD``) against their
  exact-Jacobian runs (``BTD_EXACT``) over 100 steps in f64 and (a child
  process with ``VF_FEM_TPU_X64=0``, the JAX package's switch to float32)
  in f32: ``traj_err`` and ``f32_traj_err`` = max|u_prod - u_exact| /
  max|u_exact| of the final u, which set the card's gates where they
  exceed 5e-7.

Not collected by pytest (its name does not start with ``test_``); it
imports jax, so it is no part of the PyTorch port.
"""

import argparse
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

import chip_smoke as cs  # noqa: E402  (phase 17's configuration)

EVERY_U = 8


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _state(fin):
    return {k: np.asarray(v) for k, v in fin.sub_items()}


def run_pure(model, times, params):
    from vf_fem_tpu import forward

    ini = model.state0.copy()
    ini[:] = 0.0
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    cs_ = forward._stack_controls(model, [model.control])
    prop = model.prop_to_dict(model.prop)
    t0 = time.perf_counter()
    _, traj, infos = forward.integrate_pure(model, state0, cs_, prop, np.asarray(times), params)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    info = {k: np.asarray(getattr(infos, k)) for k in ("num_iter", "abs_err")}
    print(f"  {len(times) - 1} steps in {time.perf_counter() - t0:.1f} s (host clock of this"
          f" CPU), max|u| {np.abs(traj['u']).max():.4e}", flush=True)
    return traj, info


def run_small():
    _jax()
    import cases_3d
    import dynamical_cases
    from vf_fem_tpu import forward

    pkg = dynamical_cases.jax_pkg()
    out = {}
    for cid in cases_3d.case_ids():
        t0 = time.perf_counter()
        model, zs, times = cases_3d.build(pkg, cid)
        state = model.state0.copy()
        state[:] = 0.0
        if times is None:  # stepped by solve_state1
            model.dt = cases_3d.M5X["dt"]
            errs = []
            for _ in range(cases_3d.M5X["n_steps"]):
                state, info = model.solve_state1(state)
                model.set_ini_state(state)
                errs.append(info["abs_err"])
            fin, abs_err = state, np.array(errs)
        else:
            fin, info = forward.integrate(model, None, state, [model.control], model.prop,
                                          times, write=False)
            abs_err = np.asarray(info["all"]["abs_err"])
        for k, v in _state(fin).items():
            out[f"{cid}|{k}"] = v
        out[f"{cid}|abs_err"] = abs_err
        print(f"{cid}: {time.perf_counter() - t0:.1f} s, max abs_err {abs_err.max():.3e}",
              flush=True)
    model, _, times = cases_3d.build(pkg, "btd3d")
    for run, params in cs.EXTRUDED_SMALL_RUNS.items():
        print(f"btd3d {run}:", flush=True)
        traj, _ = run_pure(model, times, params)
        out[f"btd3d|{run}|u"] = traj["u"]
        out[f"btd3d|{run}|q"] = traj["q"]
    path = os.path.join(DATA, "golden_3d.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)", flush=True)


def build_large(mesh):
    """The 45.8k-dof model in the JAX package (bench.py's properties)."""
    _jax()
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    nz, zlen = cs.MESH3D[3:]
    model = load_fsi_model(mesh, slr.KelvinVoigtWEpithelium, flr.BernoulliAreaRatioSep,
                           coupling="explicit", zs=np.linspace(0.0, zlen, nz))
    cs.set_bench_props(model)
    model.set_prop(model.prop)
    model.set_control(model.control)
    return model


def large_mesh(tmp):
    """The 45.8k fold's mesh by the JAX package's mesher, asserted identical
    (coords and cells bit for bit, ``chip_smoke.mesh_digest``) to the
    port's cached mesh built into ``tmp``: ``(mesh, digest)``."""
    _jax()
    from vf_fem_tpu.mesh import m5_mesh
    from vf_fem_tpu.mesh.extrude import extrude_mesh
    from vf_fem_tpu.mesh.reorder import rcm_mesh
    from vf_fem_tpu_torch.mesh.cached import load_cached_m5_mesh

    name, h, iters, nz, zlen = cs.MESH3D
    t0 = time.perf_counter()
    mesh = rcm_mesh(extrude_mesh(m5_mesh(name, h=h, smooth_iters=iters),
                                 np.linspace(0.0, zlen, nz)))
    print(f"JAX mesher: {mesh.num_vertices} vertices, {mesh.num_cells} cells in"
          f" {time.perf_counter() - t0:.1f} s", flush=True)
    port, seconds = load_cached_m5_mesh(name, h, iters, cache_dir=tmp, nz=nz, zlen=zlen)
    print(f"port mesher: {seconds:.1f} s", flush=True)
    np.testing.assert_array_equal(port.coords, mesh.coords)
    np.testing.assert_array_equal(port.cells, mesh.cells)
    digest = cs.mesh_digest(mesh)
    assert cs.mesh_digest(port) == digest, "the port's mesh differs from the JAX package's"
    return mesh, digest


def traj_errs(model, dtype=np.float64):
    """Final-u trajectory error of the production run against its
    exact-Jacobian run, 100 steps, each run in ``dtype``."""
    times = cs.DT * np.arange(cs.N_STEPS + 1)
    prod, _ = run_pure(model, times, cs.BTD_PROD)
    exact, _ = run_pure(model, times, cs.BTD_EXACT)
    assert prod["u"].dtype == exact["u"].dtype == dtype, prod["u"].dtype
    u, ux = prod["u"][-1].astype(np.float64), exact["u"][-1].astype(np.float64)
    return float(np.abs(u - ux).max() / np.abs(ux).max())


def run_large(child_out=None):
    with tempfile.TemporaryDirectory() as tmp:
        mesh, digest = large_mesh(tmp)
        model = build_large(mesh)
        print(f"model: {model.solid.ndof} dofs", flush=True)
        if child_out is not None:
            np.savez(child_out, f32_traj_err=traj_errs(model, np.float32))
            return
        print("tight f64:", flush=True)
        tight, tight_info = run_pure(model, cs.DT * np.arange(cs.GOLDEN_3D_STEPS + 1),
                                     cs.BTD_TIGHT)
        print("production and exact-Jacobian f64:", flush=True)
        traj_err = traj_errs(model)
        path = os.path.join(tmp, "f32.npz")
        print("production and exact-Jacobian f32 (child process):", flush=True)
        subprocess.run([sys.executable, __file__, "--f32-child", path],
                       env={**os.environ, "VF_FEM_TPU_X64": "0"}, check=True)
        f32_traj_err = float(np.load(path)["f32_traj_err"])
    print(f"traj_err {traj_err!r}, f32_traj_err {f32_traj_err!r}", flush=True)
    out = os.path.join(DATA, "golden_3d_45k.npz")
    np.savez_compressed(out, u=tight["u"][:, ::EVERY_U], q=tight["q"], p_final=tight["p"][-1],
                        num_iter=tight_info["num_iter"], every=np.int64(EVERY_U),
                        traj_err=np.float64(traj_err), f32_traj_err=np.float64(f32_traj_err),
                        mesh_digest=np.str_(digest), mesh_coords=mesh.coords)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--f32-child", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.f32_child:
        run_large(args.f32_child)
    elif args.large:
        run_large()
    else:
        run_small()
    print(f"{time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
