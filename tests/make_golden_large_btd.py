"""
Generate ``tests/data/golden_large_btd_explicit.npz`` with the JAX package
on a CPU:

    python tests/make_golden_large_btd.py [--steps 100]

The model is the large-mesh benchmark model of ``bench.py``: the 23.7k-dof
RCM mesh ``meshes/M5_3layers_rcm_h006.msh``, KelvinVoigtWEpithelium +
BernoulliAreaRatioSep, the benchmark properties, psub 8000 Ba, dt 1e-4,
block-Thomas direct solves (``linear_solver='btd'``) on banded assembly.
Runs:

- **tight** (f64): the ``btd_tol`` settings of
  ``benchmarks/benchmark_large.py:130-139`` (f64 factors refreshed every
  16 steps, fixed-3 chord Newton with its trailing residual, stagnation
  ratio 0.5).  Its trajectory is the golden: u every 10 steps and the
  final u, v, a, q, p, with the Newton iteration counts.
- **production** (f64): the settings of ``bench.py:411-434`` (bf16
  factors, refresh 96, fixed-3 without the trailing residual), and its
  **exact-Jacobian** run (``bench.py:459-466``: no bf16 storage, refresh
  1).  Stored: the production run's final u, the exact run's final u and
  ``prod_traj_err`` = max|u_prod - u_exact| / max|u_exact|, the
  reference's own gate value (<= 5e-7 in ``bench.py``).
- **production and exact-Jacobian in f32**: a child process with
  ``VF_FEM_TPU_X64=0``, the JAX package's switch to float32.  Stored:
  ``prod_f32_vs_f64`` = max|u_f32 - u_f64| / max|u_f64| of the production
  runs' final u, and ``prod_f32_traj_err``, the f32 runs' own gate value.

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

from make_golden_large_bsb import REPO, build_model, rel_diff, run

OUT = os.path.join(REPO, "tests", "data", "golden_large_btd_explicit.npz")
EVERY = 10

# benchmarks/benchmark_large.py:130-139
TIGHT = {
    "assembly": "banded",
    "linear_solver": "btd",
    "jacobian_refresh_steps": 16,
    "fixed_iterations": 3,
    "stagnation_ratio": 0.5,
}
# bench.py:411-434
PROD = {
    "assembly": "banded",
    "linear_solver": "btd",
    "btd_store_dtype": "bfloat16",
    "jacobian_refresh_steps": 96,
    "fixed_iterations": 3,
    "fixed_tail_residual": False,
    "stagnation_ratio": 0.5,
}
# bench.py:459-466: the production settings with exact factors
EXACT = {**{k: v for k, v in PROD.items() if k != "btd_store_dtype"},
         "jacobian_refresh_steps": 1}


def child_f32(n_steps, out_path):
    """Production and exact-Jacobian runs in float32 (run with
    VF_FEM_TPU_X64=0)."""
    model = build_model()
    prod, prod_info = run(model, PROD, n_steps)
    exact, _ = run(model, EXACT, n_steps)
    assert prod["u"].dtype == np.float32, prod["u"].dtype
    np.savez(out_path, u=prod["u"][-1], u_exact=exact["u"][-1],
             num_iter=prod_info["num_iter"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--f32-child", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.f32_child:
        child_f32(args.steps, args.f32_child)
        return

    t0 = time.perf_counter()
    model = build_model()
    print(f"model: {model.solid.ndof} dofs", flush=True)
    print("tight f64:", flush=True)
    tight, tight_info = run(model, TIGHT, args.steps)
    print("production f64:", flush=True)
    prod, prod_info = run(model, PROD, args.steps)
    print("exact-Jacobian f64:", flush=True)
    exact, _ = run(model, EXACT, args.steps)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f32.npz")
        print("production and exact-Jacobian f32 (child process):", flush=True)
        subprocess.run(
            [sys.executable, __file__, "--steps", str(args.steps),
             "--f32-child", path],
            env={**os.environ, "VF_FEM_TPU_X64": "0"}, check=True,
        )
        f32 = dict(np.load(path))

    prod_traj_err = rel_diff(prod["u"][-1], exact["u"][-1])
    f32_vs_f64 = rel_diff(f32["u"].astype(np.float64), prod["u"][-1])
    f32_traj_err = rel_diff(f32["u"].astype(np.float64),
                            f32["u_exact"].astype(np.float64))
    print(f"prod_traj_err {prod_traj_err!r}, prod_f32_vs_f64 {f32_vs_f64!r},"
          f" prod_f32_traj_err {f32_traj_err!r}")
    np.savez_compressed(
        OUT,
        times=1e-4 * np.arange(args.steps + 1),
        steps=np.arange(EVERY, args.steps + 1, EVERY),
        u=tight["u"][EVERY - 1 :: EVERY],
        v_final=tight["v"][-1],
        a_final=tight["a"][-1],
        q_final=tight["q"][-1],
        p_final=tight["p"][-1],
        num_iter=tight_info["num_iter"],
        prod_u_final=prod["u"][-1],
        exact_u_final=exact["u"][-1],
        prod_num_iter=prod_info["num_iter"],
        prod_f32_num_iter=f32["num_iter"],
        prod_traj_err=np.float64(prod_traj_err),
        prod_f32_vs_f64=np.float64(f32_vs_f64),
        prod_f32_traj_err=np.float64(f32_traj_err),
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in"
          f" {time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
