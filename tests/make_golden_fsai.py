"""
Generate ``tests/data/golden_m5_fsai.npz`` with the JAX package on a CPU:

    python tests/make_golden_fsai.py [--steps 100] [--large]

Runs:

- **M5 FSAI** (f64): the FSAI model of ``benchmarks/probe_fsai.py:33-65``
  (``meshes/M5_CB_GA3.msh``, KelvinVoigt + BernoulliAreaRatioSep, a WRA
  tract of 44 tubes, 1.3 cm^2 then 6.0 cm^2, psub 8000 Ba) with the contact
  plane at ``ymax + 0.005``, below the midline ``ymid = ymax + 0.01`` (the
  probe's ``ycontact = ymid`` lies outside the envelope that
  ``check_envelope`` enforces), from rest at the tract's dt (2.334e-5 s),
  with the M5 headline's solver settings (``bench.py:291-314``: fixed-2
  chord Newton, dense factors refreshed every 25 steps with Newton-Schulz;
  assembly 'plain' on the CPU).  Stored: u every 10 steps, q at every
  step, the final u, v, a, q, p, pinc and pref, each step's Newton
  iterations and ``bracketed``, and the configuration (``config``, JSON).
- **M5 FSAI in f32**: a child process with ``VF_FEM_TPU_X64=0``, the JAX
  package's switch to float32.  Stored: its u every 10 steps, q, final
  pinc and pref, and ``f32_vs_f64_steps`` = max|u_f32 - u_f64| /
  max|u_f64| every 10 steps.
- with ``--large``, **23.7k FSAI**: the production btd model
  (``meshes/M5_3layers_rcm_h006.msh``, KelvinVoigtWEpithelium +
  BernoulliAreaRatioSep, the ``bench.py`` properties) in the same tract
  with the contact plane at ``ymax + 0.005``, on the production settings
  (``bench.py:411-434``) and on their exact-Jacobian counterpart, in f64
  and (a child process) in f32; prints whether the runs stay finite and
  bracketed and their trajectory error (max|u - u_exact| / max|u_exact| of
  the final u), and stores them (``large_*``, ``large_f32_*``).  The f64
  runs take ~6 minutes on an 8-core CPU, the f32 ones about as long.

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

from make_golden_large_bsb import REPO, _jax, rel_diff

OUT = os.path.join(REPO, "tests", "data", "golden_m5_fsai.npz")
EVERY = 10
NUM_TUBE = 44
PSUB = 8000.0
# bench.py:291-314, the M5 headline settings ('plain' assembly on a CPU)
HEADLINE = {
    "jacobian_update": "once_per_step",
    "stagnation_ratio": 0.5,
    "jacobian_refresh_steps": 25,
    "jacobian_refresh_mode": "ns",
    "jacobian_full_refresh_windows": 4,
    "fixed_iterations": 2,
    "assembly": "plain",
}
# benchmarks/probe_fsai.py:47-58, the contact plane moved below the midline
M5_PROPS = dict(emod=3e4, rho=1.0, eta=2.0, nu=0.45, kcontact=1e8,
                rho_air=1.1225e-3, r_sep=1.0, area_lb=1e-4)
# bench.py:111-129 (the production model's properties)
LARGE_PROPS = dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, emod_membrane=0.0,
                   nu_membrane=0.3, th_membrane=0.0, kcontact=1e8,
                   rho_air=1.1225e-3, r_sep=1.0, area_lb=1e-4)
YCONTACT_ABOVE_YMAX = 0.005
YMID_ABOVE_YMAX = 0.01
# bench.py:411-434 and its exact-Jacobian run, :459-466
BTD_PROD = {"assembly": "banded", "linear_solver": "btd", "btd_store_dtype": "bfloat16",
            "jacobian_refresh_steps": 96, "fixed_iterations": 3,
            "fixed_tail_residual": False, "stagnation_ratio": 0.5}
BTD_EXACT = {**{k: v for k, v in BTD_PROD.items() if k != "btd_store_dtype"},
             "jacobian_refresh_steps": 1}


def tract_areas(n_tube=NUM_TUBE):
    """The probe's tract: a narrow pharynx then a wide mouth."""
    area = np.full(n_tube, 1.3)
    area[n_tube // 2:] = 6.0
    return area


def build(mesh_name="M5_CB_GA3.msh", solid="KelvinVoigt", props=M5_PROPS):
    _jax()
    from vf_fem_tpu.load import load_fsai_model
    from vf_fem_tpu.mesh import load_gmsh
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    mesh = load_gmsh(os.path.join(REPO, "meshes", mesh_name))
    model = load_fsai_model(mesh, getattr(slr, solid), flr.BernoulliAreaRatioSep,
                            num_tube=NUM_TUBE)
    ymax = mesh.coords[:, 1].max()
    prop = model.prop
    for k, v in props.items():
        prop[k][:] = v
    prop["ycontact"][:] = ymax + YCONTACT_ABOVE_YMAX
    prop["ymid"][:] = ymax + YMID_ABOVE_YMAX
    prop["area"][:] = tract_areas()
    prop["proploss"][:] = 1.0
    model.set_prop(prop)
    assert model.check_envelope()
    model.control["psub"][:] = PSUB
    model.set_control(model.control)
    return model


def run(model, params, n_steps):
    from vf_fem_tpu import forward

    ini = model.state0.copy()
    ini[:] = 0.0
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    prop = model.prop_to_dict(model.prop)
    t0 = time.perf_counter()
    fin, traj, infos = forward.integrate_pure(
        model, state0, cs, prop, model.dt * np.arange(n_steps + 1), params)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    infos = {k: np.asarray(getattr(infos, k)) for k in infos._fields}
    print(f"  {n_steps} steps in {time.perf_counter() - t0:.1f} s (host clock of"
          f" this CPU), Newton iterations {infos['num_iter'].tolist()[:8]}...,"
          f" lagged steps {int((~infos['bracketed']).sum())}, finite"
          f" {all(np.isfinite(v).all() for v in traj.values())}", flush=True)
    return traj, infos


def child_f32(n_steps, out_path):
    """The M5 FSAI run in float32 (run with VF_FEM_TPU_X64=0)."""
    traj, infos = run(build(), HEADLINE, n_steps)
    assert traj["u"].dtype == np.float32, traj["u"].dtype
    np.savez(out_path, u=traj["u"][EVERY - 1 :: EVERY], q=traj["q"].ravel(),
             pinc_final=traj["pinc"][-1], pref_final=traj["pref"][-1],
             num_iter=infos["num_iter"])


def large(n_steps):
    """The 23.7k FSAI configuration on the production settings and on the
    exact Jacobian: (traj_err, lagged steps, finite)."""
    model = build("M5_3layers_rcm_h006.msh", "KelvinVoigtWEpithelium", LARGE_PROPS)
    print(f"23.7k FSAI ({model.solid.ndof} dofs), production btd:", flush=True)
    traj, infos = run(model, BTD_PROD, n_steps)
    print("23.7k FSAI, exact Jacobian:", flush=True)
    traj_x, infos_x = run(model, BTD_EXACT, n_steps)
    err = rel_diff(traj["u"][-1], traj_x["u"][-1])
    lagged = int((~infos["bracketed"]).sum() + (~infos_x["bracketed"]).sum())
    finite = all(np.isfinite(v).all() for t in (traj, traj_x) for v in t.values())
    print(f"  traj_err {err!r}, lagged steps {lagged}, finite {finite}", flush=True)
    return err, lagged, finite


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--f32-child", metavar="NPZ", help=argparse.SUPPRESS)
    ap.add_argument("--large-f32-child", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.f32_child:
        child_f32(args.steps, args.f32_child)
        return
    if args.large_f32_child:
        err, lagged, finite = large(args.steps)
        np.savez(args.large_f32_child, err=err, lagged=lagged, finite=finite)
        return

    t0 = time.perf_counter()
    print("M5 FSAI f64:", flush=True)
    model = build()
    traj, infos = run(model, HEADLINE, args.steps)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f32.npz")
        print("M5 FSAI f32 (child process):", flush=True)
        subprocess.run(
            [sys.executable, __file__, "--steps", str(args.steps), "--f32-child", path],
            env={**os.environ, "VF_FEM_TPU_X64": "0"}, check=True,
        )
        f32 = dict(np.load(path))
    u64 = traj["u"][EVERY - 1 :: EVERY]
    f32_steps = np.array([rel_diff(a.astype(np.float64), b) for a, b in zip(f32["u"], u64)])
    print(f"f32_vs_f64 every {EVERY} steps {f32_steps.tolist()}", flush=True)
    config = dict(mesh="meshes/M5_CB_GA3.msh", solid="KelvinVoigt",
                  fluid="BernoulliAreaRatioSep", num_tube=NUM_TUBE, psub=PSUB,
                  props=M5_PROPS, ycontact_above_ymax=YCONTACT_ABOVE_YMAX,
                  ymid_above_ymax=YMID_ABOVE_YMAX, tract_area=tract_areas().tolist(),
                  proploss=1.0, params=HEADLINE, dt=model.dt)
    extra = {}
    if args.large:
        err, lagged, finite = large(args.steps)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "large_f32.npz")
            print("23.7k FSAI f32 (child process):", flush=True)
            subprocess.run(
                [sys.executable, __file__, "--steps", str(args.steps),
                 "--large-f32-child", path],
                env={**os.environ, "VF_FEM_TPU_X64": "0"}, check=True,
            )
            f32_large = dict(np.load(path))
        extra = dict(large_traj_err=np.float64(err), large_lagged=np.int64(lagged),
                     large_finite=np.bool_(finite),
                     large_f32_traj_err=np.float64(f32_large["err"]),
                     large_f32_lagged=np.int64(f32_large["lagged"]),
                     large_f32_finite=np.bool_(f32_large["finite"]))

    np.savez_compressed(
        OUT,
        config=np.array(json.dumps(config)),
        times=model.dt * np.arange(args.steps + 1),
        steps=np.arange(EVERY, args.steps + 1, EVERY),
        u=u64,
        q=traj["q"].ravel(),
        **{f"{k}_final": traj[k][-1] for k in ("u", "v", "a", "q", "p", "pinc", "pref")},
        num_iter=infos["num_iter"],
        bracketed=infos["bracketed"],
        f32_u=f32["u"],
        f32_q=f32["q"],
        f32_pinc_final=f32["pinc_final"],
        f32_pref_final=f32["pref_final"],
        f32_num_iter=f32["num_iter"],
        f32_vs_f64_steps=f32_steps,
        **extra,
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in"
          f" {time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
