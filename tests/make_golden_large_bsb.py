"""
Generate ``tests/data/golden_large_bsb_explicit.npz`` with the JAX package
on a CPU:

    python tests/make_golden_large_bsb.py [--steps 20]

The model is the large-mesh benchmark model of ``bench.py``: the 23.7k-dof
RCM mesh ``meshes/M5_3layers_rcm_h006.msh``, KelvinVoigtWEpithelium +
BernoulliAreaRatioSep, the benchmark properties, psub 8000 Ba, dt 1e-4.
Three runs:

- **tight** (f64): ``linear_solver='bsb'``, BiCGStab to 1e-10 (at most
  1000 iterations), the Jacobian re-assembled every step, banded assembly.
  Its trajectory is the golden: u every 5 steps and the final u, v, a, q,
  p, with the Newton iteration counts.
- **production** (f64 and f32): the settings of
  ``benchmarks/benchmark_large.py:118-125`` (BiCGStab to 1e-4, at most 200
  iterations, the block-banded Jacobian refreshed every 8 steps,
  stagnation ratio 0.5).  Stored: ``prod_traj_err`` =
  max|u_prod - u_tight| / max|u_tight| of the final displacement (f64), and
  ``prod_f32_vs_f64`` = max|u_f32 - u_f64| / max|u_f64| of the production
  run's final displacement.  The f32 run is a child process with
  ``VF_FEM_TPU_X64=0``, the JAX package's switch to float32.

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

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESH = os.path.join(REPO, "meshes", "M5_3layers_rcm_h006.msh")
OUT = os.path.join(REPO, "tests", "data", "golden_large_bsb_explicit.npz")
DT = 1e-4
EVERY = 5

TIGHT = {
    "assembly": "banded",
    "linear_solver": "bsb",
    "krylov_tolerance": 1e-10,
    "krylov_max_iter": 1000,
    "jacobian_refresh_steps": 1,
}
# benchmarks/benchmark_large.py:118-125
PROD = {
    "assembly": "banded",
    "linear_solver": "bsb",
    "krylov_tolerance": 1e-4,
    "krylov_max_iter": 200,
    "jacobian_refresh_steps": 8,
    "stagnation_ratio": 0.5,
}
# bench.py:111-129
PROPS = dict(
    emod=5e4, rho=1.0, eta=3.0, nu=0.45, emod_membrane=0.0,
    nu_membrane=0.3, th_membrane=0.0, kcontact=1e8, rho_air=1.1225e-3,
    r_sep=1.0, area_lb=1e-4,
)


def _jax():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def build_model():
    _jax()
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    model = load_fsi_model(
        MESH, slr.KelvinVoigtWEpithelium, flr.BernoulliAreaRatioSep,
        coupling="explicit",
    )
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    prop = model.prop
    for k, v in PROPS.items():
        prop[k][:] = v
    prop["ycontact"][:] = ymax + 0.05
    prop["ymid"][:] = ymax + 0.01
    model.set_prop(prop)
    model.control["psub"][:] = 8000.0
    model.control["psup"][:] = 0.0
    model.set_control(model.control)
    return model


def run(model, params, n_steps):
    from vf_fem_tpu import forward

    ini = model.state0.copy()
    ini[:] = 0.0
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    prop = model.prop_to_dict(model.prop)
    times = DT * np.arange(n_steps + 1)
    t0 = time.perf_counter()
    fin, traj, infos = forward.integrate_pure(
        model, state0, cs, prop, times, params
    )
    traj = {k: np.asarray(v) for k, v in traj.items()}
    infos = {k: np.asarray(getattr(infos, k))
             for k in ("num_iter", "abs_err", "rel_err")}
    print(f"  {n_steps} steps in {time.perf_counter() - t0:.1f} s (host clock"
          f" of this CPU), Newton iterations {infos['num_iter'].tolist()},"
          f" max abs_err {infos['abs_err'].max():.3e}", flush=True)
    return traj, infos


def rel_diff(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def child_f32(n_steps, out_path):
    """Production run in float32 (run with VF_FEM_TPU_X64=0)."""
    model = build_model()
    traj, infos = run(model, PROD, n_steps)
    assert traj["u"].dtype == np.float32, traj["u"].dtype
    np.savez(out_path, u=traj["u"][-1], num_iter=infos["num_iter"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--f32-child", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.f32_child:
        child_f32(args.steps, args.f32_child)
        return

    model = build_model()
    print(f"model: {model.solid.ndof} dofs", flush=True)
    print("tight f64:", flush=True)
    tight, tight_info = run(model, TIGHT, args.steps)
    print("production f64:", flush=True)
    prod, prod_info = run(model, PROD, args.steps)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f32.npz")
        print("production f32 (child process):", flush=True)
        subprocess.run(
            [sys.executable, __file__, "--steps", str(args.steps),
             "--f32-child", path],
            env={**os.environ, "VF_FEM_TPU_X64": "0"}, check=True,
        )
        f32 = dict(np.load(path))

    prod_traj_err = rel_diff(prod["u"][-1], tight["u"][-1])
    f32_vs_f64 = rel_diff(f32["u"].astype(np.float64), prod["u"][-1])
    print(f"prod_traj_err {prod_traj_err!r}, prod_f32_vs_f64 {f32_vs_f64!r}")
    np.savez_compressed(
        OUT,
        times=DT * np.arange(args.steps + 1),
        steps=np.arange(EVERY, args.steps + 1, EVERY),
        u=tight["u"][EVERY - 1 :: EVERY],
        v_final=tight["v"][-1],
        a_final=tight["a"][-1],
        q_final=tight["q"][-1],
        p_final=tight["p"][-1],
        num_iter=tight_info["num_iter"],
        prod_num_iter=prod_info["num_iter"],
        prod_f32_num_iter=f32["num_iter"],
        prod_traj_err=np.float64(prod_traj_err),
        prod_f32_vs_f64=np.float64(f32_vs_f64),
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
