"""
Generate ``tests/data/golden_m5_implicit.npz`` with the JAX package on a
CPU:

    python tests/make_golden_implicit.py [--steps 100]

Runs:

- **M5 implicit** (f64): the implicit-coupling leg of ``bench.py``
  (``build_implicit``, ``bench.py:787-822``: ``meshes/M5_3layers.msh``,
  KelvinVoigtWEpithelium + BernoulliSmoothMinSep, the benchmark
  properties, psub 8000 Ba) with the leg's settings (``bench.py:493-497``:
  dense factors refreshed every 25 steps, stagnation ratio 0.5, Aitken
  relaxation), from rest at dt = 1e-4.  Stored: u every 10 steps, the
  final u, v, a, q, p, and each step's Picard iterations and residuals.
- **M5 implicit in f32**: a child process with ``VF_FEM_TPU_X64=0``, the
  JAX package's switch to float32.  Stored: ``f32_vs_f64`` =
  max|u_f32 - u_f64| / max|u_f64| of the final displacement,
  ``f32_vs_f64_steps``, the same every 10 steps, and the f32 run's Picard
  iterations.
- **23.7k static**: ``static.static_coupled_configuration_picard`` on the
  Hopf leg's model (``bench.py:533-575``: ``meshes/M5_3layers_rcm_h006.msh``,
  KelvinVoigt + BernoulliSmoothMinSep, psub 500 Ba, static Newton on
  block-Thomas solves, ``{"linear_solver": "btd"}``).  Stored: the static
  u, q, p and the Picard iterations and residual.

The M5 implicit run stops converging at step 15 (Picard residual 51, then
1.2e13 at step 16, where the glottal area turns negative: the contact
plane lies above the midline), in f64 and f32 alike; from there each
step's Picard loop stagnates after one or two iterations, and the final
u differs between f32 and f64 by ~1x its size.

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

from make_golden_large_bsb import REPO, _jax, rel_diff

OUT = os.path.join(REPO, "tests", "data", "golden_m5_implicit.npz")
DT = 1e-4
EVERY = 10
# bench.py:493-497
IMPLICIT = {"jacobian_refresh_steps": 25, "stagnation_ratio": 0.5, "aitken": True}
STATIC_OPTIONS = {"linear_solver": "btd"}  # bench.py:566
STATIC_PSUB = 500.0  # bench.py:563


def build_implicit():
    """bench.py:787-822."""
    _jax()
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.mesh import load_gmsh
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    mesh = load_gmsh(os.path.join(REPO, "meshes", "M5_3layers.msh"))
    ymax = mesh.coords[:, 1].max()
    model = load_fsi_model(mesh, slr.KelvinVoigtWEpithelium,
                           flr.BernoulliSmoothMinSep, coupling="implicit")
    prop = model.prop
    for k, v in dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, emod_membrane=0.0,
                     nu_membrane=0.3, th_membrane=0.0, ycontact=ymax + 0.05,
                     kcontact=1e8, rho_air=1.1225e-3, zeta_min=1e-3,
                     zeta_sep=1e-3, ymid=ymax + 0.01).items():
        prop[k][:] = v
    model.set_prop(prop)
    model.control["psub"][:] = 8000.0
    model.control["psup"][:] = 0.0
    model.set_control(model.control)
    return model


def build_static():
    """The transient model of the Hopf leg, bench.py:543-575."""
    _jax()
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.mesh import load_gmsh
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    mesh = load_gmsh(os.path.join(REPO, "meshes", "M5_3layers_rcm_h006.msh"))
    ymax = mesh.coords[:, 1].max()
    model = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep)
    prop = model.prop
    for k, v in dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, ycontact=ymax + 0.05,
                     kcontact=1e8, rho_air=1.1225e-3, zeta_min=1e-3,
                     zeta_sep=1e-3, ymid=ymax + 0.01).items():
        prop[k][:] = v
    model.set_prop(prop)
    control = model.control.copy()
    control["psub"][:] = STATIC_PSUB
    control["psup"][:] = 0.0
    return model, control


def run_implicit(model, n_steps):
    from vf_fem_tpu import forward

    ini = model.state0.copy()
    ini[:] = 0.0
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    prop = model.prop_to_dict(model.prop)
    t0 = time.perf_counter()
    fin, traj, infos = forward.integrate_pure(
        model, state0, cs, prop, DT * np.arange(n_steps + 1), IMPLICIT)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    infos = {k: np.asarray(getattr(infos, k)) for k in ("num_iter", "abs_err", "rel_err")}
    print(f"  {n_steps} steps in {time.perf_counter() - t0:.1f} s (host clock of"
          f" this CPU), Picard iterations {infos['num_iter'].tolist()}", flush=True)
    return traj, infos


def child_f32(n_steps, out_path):
    """The M5 implicit run in float32 (run with VF_FEM_TPU_X64=0)."""
    traj, infos = run_implicit(build_implicit(), n_steps)
    assert traj["u"].dtype == np.float32, traj["u"].dtype
    np.savez(out_path, u=traj["u"][EVERY - 1 :: EVERY], num_iter=infos["num_iter"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--f32-child", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.f32_child:
        child_f32(args.steps, args.f32_child)
        return

    t0 = time.perf_counter()
    print("M5 implicit f64:", flush=True)
    traj, infos = run_implicit(build_implicit(), args.steps)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f32.npz")
        print("M5 implicit f32 (child process):", flush=True)
        subprocess.run(
            [sys.executable, __file__, "--steps", str(args.steps), "--f32-child", path],
            env={**os.environ, "VF_FEM_TPU_X64": "0"}, check=True,
        )
        f32 = dict(np.load(path))
    u64 = traj["u"][EVERY - 1 :: EVERY]
    f32_steps = np.array([rel_diff(a.astype(np.float64), b) for a, b in zip(f32["u"], u64)])
    f32_vs_f64 = f32_steps[-1]
    print(f"f32_vs_f64 {f32_vs_f64!r}, every {EVERY} steps {f32_steps.tolist()}", flush=True)

    from vf_fem_tpu import static

    print("23.7k static (Picard, btd):", flush=True)
    t1 = time.perf_counter()
    model, control = build_static()
    state, sinfo = static.static_coupled_configuration_picard(
        model, control, model.prop, options=STATIC_OPTIONS)
    print(f"  {model.solid.ndof} dofs in {time.perf_counter() - t1:.1f} s: {sinfo}",
          flush=True)

    np.savez_compressed(
        OUT,
        times=DT * np.arange(args.steps + 1),
        steps=np.arange(EVERY, args.steps + 1, EVERY),
        u=traj["u"][EVERY - 1 :: EVERY],
        **{f"{k}_final": traj[k][-1] for k in ("u", "v", "a", "q", "p")},
        num_iter=infos["num_iter"],
        abs_err=infos["abs_err"],
        rel_err=infos["rel_err"],
        f32_num_iter=f32["num_iter"],
        f32_vs_f64=np.float64(f32_vs_f64),
        f32_vs_f64_steps=f32_steps,
        static_u=np.asarray(state["u"]),
        static_q=np.asarray(state["q"]),
        static_p=np.asarray(state["p"]),
        static_num_iter=np.int64(sinfo["num_iter"]),
        static_abs_err=np.float64(sinfo["abs_err"]),
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in"
          f" {time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
