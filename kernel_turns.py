#!/usr/bin/env python3
"""
Time the main path's kernels of two checkouts of the port in turns, on one
NVIDIA GPU:

    python3 kernel_turns.py OLD_CHECKOUT

``OLD_CHECKOUT`` is the root of another checkout of this repository (for
example the parent commit, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists).  The script runs four processes on the card, in
the order old, new, new, old; each imports the port from its own checkout,
builds that checkout's kernels, and times, through the public wrappers that
the main path calls:

K1 ``banded_gather`` (11 channels) and K2 ``banded_scatter`` (2 channels)
on the M5-3layers and the 23.7k-dof RCM plans, f64, random values from a
seed;

K6 ``ops.btd_sweep`` and its transpose K6T ``ops.btd_sweep_t``, forward
and backward, for every (factor, vector) dtype pair (bf16/f64 for the
production runs, f64/f64 for the tight and exact-Jacobian runs, bf16/f32
and f32/f32 for the f32 runs) and every row-block width they are built for
(128, 256, 384, 512), 93 row blocks: factors and right-hand sides from a
seed, the factors scaled by 0.5/sqrt(Bt) so that the recurrence stays
bounded.  Each process prints the SHA-256 of each sweep's output bytes, so
that equal digests show two kernels bit-equal; the sweeps at the 23.7k
shapes (Bt = 256) are timed;

K5 at 23.7k dofs, f64 and f32, with the next step's Newmark predictor:
``ops.newmark_update_coefs`` with its coefficients as a row in device
memory (the time loop's launch) where the checkout has it, else
``ops.newmark_update`` (one launch where the checkout's K5 writes the
predictor, else K5 (v1, a1) and the plain predictor,
``equations.newmark``, four eager kernels), with the SHA-256 of the
three outputs;

K5T ``ops.newmark_update_t`` (K5's backward) at 23.7k dofs, f64 and f32,
from a seed of its own, with the SHA-256 of its four vector cotangents
(the plain version's bits, in every checkout that has K5T) and of the
row's cotangent (its summation order is the checkout's own);

K4 ``ops.bsb_matvec`` and its transpose K4T ``ops.bsb_matvec_t`` (where
the checkout has it, on its transposed pattern, with the SHA-256 of its
output) at 23.7k dofs, f64 and f32, on the model's block-banded Jacobian at
rest under 500 Ba (the fill of ``chip_smoke.py`` phase 3), with the
checkout's own plan and, where the checkout has one, its matvec pattern;
then the production bsb f64 run of ``chip_smoke.py``
phase 6 (20 steps after a warm-up run) under ``torch.profiler``: K4's
device time and share of device busy, the idle share, and the ms per
BiCGStab iteration at the run's middle state; then the production btd
f64 run of ``chip_smoke.py`` phase 7 (``bench.py:411-434``, 100 steps
after a warm-up run: the eager loop, or the captured CUDA-graph step where
the checkout has one), timed by CUDA events, with the SHA-256 of its
trajectory and infos; then the same run by the eager loop of steps
(``forward._integrate_eager``: every banded gather and scatter called from
Python, so its steps/s include their dispatch on the host);

the 23.7k FSAI value+grad of the RMS radiated pressure
(``chip_smoke.py`` phase 12's cell: production adjoint settings, 50 steps,
K5T 0.98 a step), three runs by CUDA events with the SHA-256 of the value
and gradients (equal within a checkout; a K5T that sums in another order
gives other bits), then one under ``cProfile``: the host time of K5T's
wrapper and the run's function calls.

Each time is taken two ways by CUDA events: the eager call (200 calls
after 20 warm-up calls) and the device time (200 calls captured in one CUDA
graph and replayed).  Prints one line per process and, last, a JSON object
with every process's numbers, whether each digest (K4T, K5, K5T, K6, K6T
and the btd trajectory) is the same in every process and whether it is the same
in the two processes of each checkout (a redesigned kernel that sums in
another order has other bits than its parent's, the same bits every
launch), and the card's name and power limit.  Exits nonzero without CUDA or
when a process fails.

To compare with the parent commit: ``mkdir -p _scratch/parent && git
archive <parent> | tar -x -C _scratch/parent``, then ``python3
kernel_turns.py _scratch/parent`` (about 15 minutes on an H100).
"""

import cProfile
import hashlib
import json
import os
import pstats
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def child(root):
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    # this checkout's timers and drivers; they import the port when called
    from chip_smoke import (ADJ_LARGE, BTD_PROD, FSAI_GRAD_STEPS, LARGE_MESH, PROD, build,
                            build_fsai, cuda_ms, fsai_grad_run, fsai_value, graph_ms,
                            krylov_iteration_ms, profile_run, rest_operator)

    sys.path.insert(0, root)  # the port of the checkout under test
    from vf_fem_tpu_torch import config, ops  # noqa: E402
    from vf_fem_tpu_torch import forward  # noqa: E402
    from vf_fem_tpu_torch.fem import banded  # noqa: E402
    from vf_fem_tpu_torch.mesh import load_gmsh  # noqa: E402
    from vf_fem_tpu_torch.solvers import bsb  # noqa: E402

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    out = {"root": root}
    for label in ("M5_3layers", "M5_3layers_rcm_h006"):
        mesh = load_gmsh(os.path.join(HERE, "meshes", label + ".msh"))
        nvert = mesh.num_vertices
        hp = banded.plan_banded(mesh.cells, nvert, gc=config.BANDED_GC)
        dp = banded.to_device(hp, dev)
        F = torch.tensor(rng.standard_normal((11, nvert)), device=dev)
        loc = torch.tensor(rng.standard_normal((dp.nv, 2, dp.ncpad)), device=dev)
        for op, fn in (("gather", lambda: banded.banded_gather(dp, F)),
                       ("scatter", lambda: banded.banded_scatter(dp, loc, nvert))):
            out[f"{op} {label}"] = dict(ms=cuda_ms(torch, fn), device_ms=graph_ms(torch, fn))
    n = 93
    pairs = ((torch.bfloat16, torch.float64), (torch.float64, torch.float64),
             (torch.bfloat16, torch.float32), (torch.float32, torch.float32))
    for bt in (256, 128, 384, 512):
        A64 = rng.standard_normal((n, bt, bt)) * (0.5 / bt ** 0.5)
        g64 = rng.standard_normal((n, bt))
        for ftype, vtype in pairs:
            A = torch.tensor(A64, device=dev).to(ftype)
            g = torch.tensor(g64, device=dev).to(vtype)
            for rev in (False, True):
                for name in ("btd_sweep", "btd_sweep_t"):
                    fn = lambda: getattr(ops, name)(A, g, reverse=rev)
                    y = fn().cpu().numpy()
                    key = (f"{name} {str(ftype).replace('torch.', '')}/"
                           f"{str(vtype).replace('torch.', '')} {bt}"
                           f" {'backward' if rev else 'forward'}")
                    out[key] = dict(sha256=hashlib.sha256(y.tobytes()).hexdigest())
                    if bt == 256:
                        out[key].update(ms=cuda_ms(torch, fn), device_ms=graph_ms(torch, fn))

    # K5 at 23.7k dofs: the state update and the next step's predictor, by
    # K5 alone where it writes all three, else by K5 and the plain predictor
    from vf_fem_tpu_torch.equations import newmark  # noqa: E402

    host = rng.standard_normal((4, 23_754))
    row_api = hasattr(ops, "newmark_update_coefs")
    for dtype in (torch.float64, torch.float32):
        u1, u0, v0, a0 = (torch.tensor(h, dtype=dtype, device=dev) for h in host)
        if row_api:  # the time loop's launch: the coefficients as a device row
            row = torch.tensor(newmark.coefficients(1e-4), dtype=torch.float64).to(dtype=dtype,
                                                                                  device=dev)
            fn = lambda: ops.newmark_update_coefs(u1, u0, v0, a0, row)
        else:
            fn = lambda: ops.newmark_update(u1, u0, v0, a0, 1e-4)
        whole = len(fn()) == 3
        if not whole:
            def fn():
                v1, a1 = ops.newmark_update(u1, u0, v0, a0, 1e-4)
                return v1, a1, newmark.newmark_predict_u(u1, v1, a1, 1e-4)
        y = torch.cat(fn()).cpu().numpy()
        out[f"newmark {str(dtype).replace('torch.', '')}"] = dict(
            sha256=hashlib.sha256(y.tobytes()).hexdigest(), ms=cuda_ms(torch, fn),
            device_ms=graph_ms(torch, fn), one_launch=whole, row=row_api)

    # K5T at 23.7k dofs (its own seed, so that the inputs after it are the
    # same with or without it): the eager call and the device time, with
    # the SHA-256 of the four vector cotangents and of the row's cotangent
    trng = np.random.default_rng(14)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        host = trng.standard_normal((6, 23_754))
        host[:2] *= 1e-3
        vecs = [torch.tensor(h, dtype=dtype, device=dev) for h in host]
        row = ops.newmark_row(newmark.coefficients(1e-4, 0.75e-4), dtype, dev)
        fn = lambda: ops.newmark_update_t(*vecs, row)
        outs = fn()
        vec = torch.cat(outs[:4]).cpu().numpy()
        out[f"newmark_t {tag}"] = dict(
            sha256=hashlib.sha256(vec.tobytes()).hexdigest(), ms=cuda_ms(torch, fn),
            device_ms=graph_ms(torch, fn))
        out[f"newmark_t row {tag}"] = dict(
            sha256=hashlib.sha256(outs[4].cpu().numpy().tobytes()).hexdigest())

    built = build(torch, dev, LARGE_MESH, torch.float64)
    model, state0, cs, prop = built
    op = rest_operator(torch, model, 500.0)
    plan, fill = model.solid.bsb_plan()
    blocks64 = bsb.bsb_fill(plan, fill, [op.J_cells, op.J_facets])
    pattern = () if getattr(fill, "pattern", None) is None else (fill.pattern,)
    x64 = rng.standard_normal(plan.ndof)
    for dtype in (torch.float64, torch.float32):
        B, x = blocks64.to(dtype), torch.tensor(x64, dtype=dtype, device=dev)
        fn = lambda: ops.bsb_matvec(plan, B, x, *pattern)
        out[f"bsb_matvec {str(dtype).replace('torch.', '')}"] = dict(
            ms=cuda_ms(torch, fn), device_ms=graph_ms(torch, fn))
        if hasattr(ops, "bsb_matvec_t"):
            fn = lambda: ops.bsb_matvec_t(plan, B, x, fill.pattern_t)
            out[f"bsb_matvec_t {str(dtype).replace('torch.', '')}"] = dict(
                sha256=hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest(),
                ms=cuda_ms(torch, fn), device_ms=graph_ms(torch, fn))
    times = np.load(os.path.join(HERE, "tests", "data", "golden_large_bsb_explicit.npz"))["times"]
    params = {**PROD, "linear_solver": "bsb"}
    traj = {}

    def run():
        traj.update(forward.integrate_pure(model, state0, cs, prop, times, params)[1])

    run()  # warm-up
    n_steps = len(times) - 1
    prof = profile_run(torch, run, n_steps, "bsb_matvec_kernel")
    state = {k: v[n_steps // 2 - 1] for k, v in traj.items()}
    iter_ms, iters = krylov_iteration_ms(torch, built, state, params)
    out["bsb prod f64 profile"] = dict(
        k4_ms=prof["k_ms"], k4_launches=prof["k_launches"], busy_ms=prof["busy_ms"],
        k4_share=prof["k_ms"] / prof["busy_ms"], idle=prof["idle"], wall_ms=prof["wall_ms"],
        iter_ms=iter_ms, iters=iters)

    # the production btd f64 run (bench.py:411-434, 100 steps): the SHA-256
    # of its trajectory and infos, and its time by CUDA events after a
    # warm-up run (the eager loop, or the captured step where the checkout
    # has one); then the same run by the eager loop of steps
    times = np.load(os.path.join(HERE, "tests", "data", "golden_large_btd_explicit.npz"))["times"]
    for key, fn in (("btd prod f64 trajectory", forward.integrate_pure),
                    ("btd prod f64 eager", forward._integrate_eager)):
        btd = lambda: fn(model, state0, cs, prop, times, BTD_PROD)
        btd()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        _, traj, infos = btd()
        end.record()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for k in sorted(traj):
            digest.update(traj[k].cpu().numpy().tobytes())
        for x in infos:
            digest.update(x.cpu().numpy().tobytes())
        out[key] = dict(sha256=digest.hexdigest(), run_ms=start.elapsed_time(end),
                        steps=len(times) - 1)

    # the 23.7k FSAI value+grad of the RMS radiated pressure (chip_smoke.py
    # phase 12's production adjoint settings, 50 steps; the gradient path
    # that runs K5T): three runs by CUDA events after the forward that
    # captures the step and a warm-up run, with the SHA-256 of the value and
    # gradients; then one more under cProfile: the host time of K5T's
    # wrapper (ops.newmark_update_t, inclusive) and the run's function calls
    built = build_fsai(torch, dev, torch.float64, large=True)
    times = np.load(os.path.join(HERE, "tests", "data", "golden_m5_fsai.npz"))["times"]
    times = times[:FSAI_GRAD_STEPS + 1]
    fsai_value(torch, built, times, ADJ_LARGE)
    fsai_grad_run(torch, built, times, ADJ_LARGE)
    for run in (1, 2, 3):
        g = fsai_grad_run(torch, built, times, ADJ_LARGE)
        digest = hashlib.sha256(np.float64(g["value"]).tobytes())
        for group in ("ini_state", "controls", "prop"):
            for k in sorted(g["grads"][group]):
                digest.update(np.ascontiguousarray(g["grads"][group][k]).tobytes())
        digest.update(np.ascontiguousarray(g["grads"]["times"]).tobytes())
        out[f"fsai value+grad 23.7k f64 run {run}"] = dict(
            sha256=digest.hexdigest(), run_ms=g["ms"], steps=FSAI_GRAD_STEPS)
    host = cProfile.Profile()
    host.enable()
    g = fsai_grad_run(torch, built, times, ADJ_LARGE)
    host.disable()
    stats = pstats.Stats(host)
    wrapper = [v for (path, _, name), v in stats.stats.items()
               if name == "newmark_update_t" and path.endswith(os.path.join("ops", "kernels.py"))]
    out["fsai value+grad 23.7k f64 host"] = dict(
        k5t_calls=sum(v[1] for v in wrapper), k5t_host_ms=sum(v[3] for v in wrapper) * 1e3,
        calls=stats.total_calls, profiled_ms=g["ms"])
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2])
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    old = os.path.abspath(sys.argv[1])
    if not os.path.isdir(os.path.join(old, "vf_fem_tpu_torch")):
        sys.exit(f"{old}: not a checkout of the port")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for which, root in (("old", old), ("new", HERE), ("new", HERE), ("old", old)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{which} ({root}) failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["which"] = which
        runs.append(res)
        print(which + ": " + ", ".join(
            k + (f" call {v['ms']:.6f} device {v['device_ms']:.6f} ms" if "ms" in v else "")
            + (f" sha256 {v['sha256'][:16]}" if "sha256" in v else "")
            + (f" K4 {v['k4_ms']:.3f} ms in {v['k4_launches']} launches, {v['k4_share']:.1%}"
               f" of busy {v['busy_ms']:.3f} ms, idle {v['idle']:.3f}, {v['iter_ms']:.4f} ms"
               f" per BiCGStab iteration ({v['iters']} a solve)" if "k4_ms" in v else "")
            + (f" {v['steps'] / (v['run_ms'] / 1e3):.2f} steps/s ({v['run_ms']:.3f} ms)"
               if "run_ms" in v else "")
            + (f" under cProfile {v['profiled_ms']:.3f} ms, {v['calls']} function calls, K5T's"
               f" wrapper {v['k5t_host_ms']:.3f} ms in {v['k5t_calls']} calls"
               if "k5t_host_ms" in v else "")
            for k, v in res.items() if isinstance(v, dict)), flush=True)
    keys = sorted({k for r in runs for k, v in r.items() if isinstance(v, dict) and "sha256" in v})
    same = {k: len({r[k]["sha256"] for r in runs if k in r}) == 1 for k in keys}
    # runs 0 and 3 are the old checkout's, 1 and 2 the new one's
    stable = {k: all(a.get(k, {}).get("sha256") == b.get(k, {}).get("sha256")
                     for a, b in ((runs[0], runs[3]), (runs[1], runs[2]))) for k in keys}
    print("bit-equal in every process: " + ", ".join(f"{k} {s}" for k, s in same.items()),
          flush=True)
    print("bit-equal within each checkout: "
          + ", ".join(f"{k} {s}" for k, s in stable.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs, "bit_equal": same,
                      "bit_equal_within_checkout": stable}), flush=True)


if __name__ == "__main__":
    main()
