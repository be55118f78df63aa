#!/usr/bin/env python3
"""
Smoke test of the PyTorch/CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vf_fem_tpu_torch/csrc`` (into
``vf_fem_tpu_torch/_build/``) and runs, in order:

1. device: the card's name and power limit (fails without CUDA);
2. kernels: the banded gather (K1) and scatter (K2), and both backward
   paths, against their plain PyTorch versions on the card, at the
   M5-3layers plan and the 23.7k-dof RCM plan, in f64 and f32, with
   CUDA-event times of each kernel and its plain version;
3. golden: the explicit-FSI M5_CB_GA3 trajectory in f64 with the default
   solver parameters (banded assembly) against
   ``tests/data/golden_m5cad_explicit.npz``;
4. headline: the benchmark model of ``bench.py`` (M5-3layers, headline
   solver settings, 100 steps at dt = 1e-4) in f64 and f32, with steps/s,
   the launch counts of K1/K2 in that run, and the f32-vs-f64 difference
   of the final displacement against its gate.

Every phase raises on failure, so the script exits nonzero; on success its
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 100
DT = 1e-4
# bench.py:291-314, the headline solver settings
HEADLINE = {
    "jacobian_update": "once_per_step",
    "stagnation_ratio": 0.5,
    "jacobian_refresh_steps": 25,
    "jacobian_refresh_mode": "ns",
    "jacobian_full_refresh_windows": 4,
    "fixed_iterations": 2,
    "assembly": "banded",
}
# max|u_f32 - u_f64| / max|u_f64| of the final displacement of this
# headline run, measured with the JAX package on a CPU (x86-64, same mesh,
# properties and settings, assembly 'plain'); the port's f32 run is gated
# at 10x this value
JAX_CPU_F32_VS_F64 = 1.9176514355193498e-06
KERNELS = {
    "gather": ("banded_gather", "vf_fem_tpu/fem/banded.py:174"),
    "scatter": ("banded_scatter", "vf_fem_tpu/fem/banded.py:191"),
}
WARMUP, REPS = 20, 200


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*args):
    print(*args, flush=True)


def phase_device(torch):
    require(torch.cuda.is_available(), "no CUDA device: the port's kernels need one")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s); device 0: {name}")
    log(card)
    return name, card


def cuda_ms(torch, fn, reps=REPS):
    """Mean time of ``fn()`` by CUDA events, after a warm-up."""
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(torch, dev):
    """K1/K2 and their VJPs against the plain versions, at the channel
    counts of the KelvinVoigtWEpithelium main path: 11 gathered channels
    (a1, u1, v1, p1, tcontact, X), 2 scattered (the residual)."""
    from vf_fem_tpu_torch import config
    from vf_fem_tpu_torch.fem import banded
    from vf_fem_tpu_torch.mesh import load_gmsh

    results = {}
    for label in ("M5_3layers", "M5_3layers_rcm_h006"):
        mesh = load_gmsh(os.path.join(REPO, "meshes", label + ".msh"))
        nvert = mesh.num_vertices
        hp = banded.plan_banded(mesh.cells, nvert, gc=config.BANDED_GC)
        dp = banded.to_device(hp, dev)
        log(f"[kernels] {label}: {nvert} vertices, {mesh.num_cells} cells,"
            f" ngroups={dp.ngroups} gc={dp.gc} w={dp.w} nvert_pad={dp.nvert_pad}")
        rng = np.random.default_rng(0)
        host = dict(
            F=rng.standard_normal((11, nvert)),
            loc=rng.standard_normal((dp.nv, 2, dp.ncpad)),
            ct_loc=rng.standard_normal((dp.nv, 11, dp.ncpad)),
            ct_rows=rng.standard_normal((2, nvert)),
        )
        for dtype in (torch.float64, torch.float32):
            t = {k: torch.tensor(v, dtype=dtype, device=dev) for k, v in host.items()}
            # gathers are copies: exact.  Scatters: rtol 1e-13 (f64) or
            # 1e-6 (f32), or within the bound on summation-order differences
            rtol = 1e-13 if dtype == torch.float64 else 1e-6
            F = t["F"].clone().requires_grad_()
            loc = t["loc"].clone().requires_grad_()
            g_out = banded.banded_gather(dp, F)
            s_out = banded.banded_scatter(dp, loc, nvert)
            (gF,) = torch.autograd.grad(g_out, F, t["ct_loc"])
            (gloc,) = torch.autograd.grad(s_out, loc, t["ct_rows"])
            checks = {
                "gather": (g_out, banded.banded_gather_reference(dp, t["F"], dp.g), None),
                "scatter": (s_out, banded.banded_scatter_reference(dp, t["loc"], nvert, dp.s),
                            banded.scatter_order_bound(dp, t["loc"], nvert, dp.s)),
                "gather_vjp": (gF, banded.banded_scatter_reference(dp, t["ct_loc"], nvert, dp.g),
                               banded.scatter_order_bound(dp, t["ct_loc"], nvert, dp.g)),
                "scatter_vjp": (gloc, banded.banded_gather_reference(dp, t["ct_rows"], dp.s), None),
            }
            torch.cuda.synchronize()
            errs = {}
            for op, (out, ref, bound) in checks.items():
                diff = (out - ref).abs()
                errs[op] = diff.max().item()
                if bound is None:
                    require(errs[op] == 0.0, f"{label} {dtype} {op}: not exact ({errs[op]:.3e})")
                else:
                    off = int((diff > rtol * ref.abs() + bound).sum())
                    require(off == 0, f"{label} {dtype} {op}: {off} entries off"
                                      f" (max |diff| {errs[op]:.3e})")
            F0, loc0 = t["F"], t["loc"]
            times = {
                "gather": (cuda_ms(torch, lambda: banded._gather(dp, F0, dp.g)),
                           cuda_ms(torch, lambda: banded.banded_gather_reference(dp, F0, dp.g))),
                "scatter": (cuda_ms(torch, lambda: banded._scatter(dp, loc0, nvert, dp.s)),
                            cuda_ms(torch, lambda: banded.banded_scatter_reference(dp, loc0, nvert, dp.s))),
            }
            tag = str(dtype).replace("torch.", "")
            for op in ("gather", "scatter"):
                ms, plain_ms = times[op]
                log(f"[kernels] {KERNELS[op][0]} {label} {tag}: kernel {ms:.6f} ms,"
                    f" plain {plain_ms:.6f} ms, max_abs_err {errs[op]:.3e}"
                    f" (vjp {errs[op + '_vjp']:.3e})")
                results[(label, tag, op)] = dict(ms=ms, plain_ms=plain_ms,
                                                 max_abs_err=errs[op])
    return results


def set_bench_props(model):
    """Properties and controls of bench.py:111-129 (and
    tests/test_golden.py:103-120)."""
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    p = model.prop
    for k, v in dict(
        emod=5e4, rho=1.0, eta=3.0, nu=0.45, emod_membrane=0.0,
        nu_membrane=0.3, th_membrane=0.0, ycontact=ymax + 0.05,
        kcontact=1e8, rho_air=1.1225e-3, r_sep=1.0, area_lb=1e-4,
        ymid=ymax + 0.01,
    ).items():
        p[k][:] = v
    model.control["psub"][:] = 8000.0
    model.control["psup"][:] = 0.0


def build(torch, dev, mesh_name, dtype):
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    model = load_fsi_model(
        os.path.join(REPO, "meshes", mesh_name), slr.KelvinVoigtWEpithelium,
        flr.BernoulliAreaRatioSep, device=dev, dtype=dtype,
    )
    set_bench_props(model)
    state0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    controls = {k: v[None] for k, v in model.control.items()}
    return model, state0, controls, model.prop


def phase_golden(torch, dev):
    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.fem import banded

    data = np.load(os.path.join(REPO, "tests", "data", "golden_m5cad_explicit.npz"))
    model, state0, cs, prop = build(torch, dev, "M5_CB_GA3.msh", torch.float64)
    require(model.solid.use_banded({}), "golden: 'auto' did not pick the banded path")
    banded.LAUNCHES.update(gather=0, scatter=0)
    fin, traj, infos = forward.integrate_pure(model, state0, cs, prop, data["times"])
    torch.cuda.synchronize()
    launches = dict(banded.LAUNCHES)
    require(min(launches.values()) > 0, f"golden: banded kernels not launched {launches}")
    u = traj["u"].cpu().numpy()[::8]
    q = traj["q"].cpu().numpy().ravel()
    p_fin = traj["p"].cpu().numpy()[-1]
    np.testing.assert_allclose(u, data["u"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(q, data["q"], rtol=1e-8)
    np.testing.assert_allclose(p_fin, data["p_final"], rtol=1e-8, atol=1e-8)
    log(f"[golden] M5_CB_GA3 f64, {len(data['times']) - 1} steps: max|du|"
        f" {np.abs(u - data['u']).max():.3e} (max|u| {np.abs(data['u']).max():.3e}),"
        f" Newton iterations {int(infos.num_iter.sum())}, launches {launches}: ok")


def phase_headline(torch, dev, card):
    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.fem import banded

    times = DT * np.arange(N_STEPS + 1)
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        model, state0, cs, prop = build(torch, dev, "M5_3layers.msh", dtype)
        run = lambda: forward.integrate_pure(model, state0, cs, prop, times, HEADLINE)
        run()  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        banded.LAUNCHES.update(gather=0, scatter=0)
        start.record()
        fin, traj, infos = run()
        end.record()
        torch.cuda.synchronize()
        launches = dict(banded.LAUNCHES)
        ms = start.elapsed_time(end)
        require(min(launches.values()) > 0, f"headline {tag}: kernels not launched {launches}")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"headline {tag}: non-finite {k}")
        require(tuple(traj["u"].shape) == (N_STEPS, model.solid.ndof), "headline: bad shape")
        steps_s = N_STEPS / (ms / 1e3)
        log(f"[headline] M5_3layers {tag} ({model.solid.ndof} dofs): {steps_s:.2f} steps/s"
            f" ({ms:.3f} ms / {N_STEPS} steps, CUDA events), launches {launches},"
            f" mean Newton rel_err {float(infos.rel_err.mean()):.3e} on {card}")
        out[tag] = dict(u=fin["u"].double().cpu().numpy(), steps_s=steps_s,
                        launches=launches)
    u64, u32 = out["float64"]["u"], out["float32"]["u"]
    rel = float(np.abs(u32 - u64).max() / np.abs(u64).max())
    gate = 10 * JAX_CPU_F32_VS_F64
    log(f"[headline] f32 vs f64 final u: max rel diff {rel:.3e}"
        f" (gate {gate:.3e} = 10 x JAX CPU {JAX_CPU_F32_VS_F64:.3e})")
    require(rel <= gate, "headline: f32 run outside its gate")
    return out


def main():
    import torch

    sys.path.insert(0, REPO)
    import vf_fem_tpu_torch  # noqa: F401  (fails outside a checkout)

    name, card = phase_device(torch)
    dev = torch.device("cuda:0")
    kern = phase_kernels(torch, dev)
    phase_golden(torch, dev)
    head = phase_headline(torch, dev, card)
    kernels = []
    for op, (kname, replaces) in KERNELS.items():
        r = kern[("M5_3layers", "float64", op)]
        kernels.append(dict(
            name=kname, route="cuda", source="vf_fem_tpu_torch/csrc/banded.cu",
            replaces=replaces, launches=head["float64"]["launches"][op],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
