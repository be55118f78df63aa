#!/usr/bin/env python3
"""
Smoke test of the PyTorch/CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vf_fem_tpu_torch/csrc`` (into
``vf_fem_tpu_torch/_build/``, one ``nvcc`` per source, all at once) and
runs, in order:

1. device: the card's name and power limit (fails without CUDA);
2. kernels: the banded gather (K1) and scatter (K2), and both backward
   paths, against their plain PyTorch versions on the card, at the
   M5-3layers plan and the 23.7k-dof RCM plan, in f64 and f32;
3. ops: the element-by-element matvec (K3) and its transpose (K3T), the
   block-banded matvec (K4) and its transpose (K4T, on the transposed
   pattern: bit for bit its CPU emulation, the same bits in three
   launches), the fused Newmark update (K5) and its backward (K5T) against
   their plain versions on the card, on the 23.7k-dof model's Jacobian (and
   at M5 size for K3/K3T/K5/K5T), in f64 and f32; K5T's vector cotangents bit for
   bit, its row's cotangent within the summation-order bound and
   bit-stable across three launches; K4 also bit for bit against its CPU
   emulation
   (``tests/bsb_emulation.py``), with its bound counted from the plan's
   matvec pattern beside the dense band's; K5's three outputs (v1, a1 and
   the next step's predictor) bit for bit, its coefficients read from a
   row in device memory, eagerly, in a CUDA-graph replay that reads
   another row of a table at each replay, and at an odd length, on
   unaligned views and with another predictor step;
4. golden: the explicit-FSI M5_CB_GA3 trajectory in f64 with the default
   solver parameters (banded assembly) against
   ``tests/data/golden_m5cad_explicit.npz``;
5. headline: the benchmark model of ``bench.py`` (M5-3layers, headline
   solver settings, 100 steps at dt = 1e-4; a fixed-iteration run, so
   each step a replay of the captured step) in f64 and f32, with steps/s,
   the launch counts of K1/K2/K5 in that run, and the f32-vs-f64
   difference of the final displacement against its gate, then one
   ``torch.profiler`` pass of the f64 run;
6. krylov: the matrix-free Newton-Krylov path on the 23.7k-dof RCM mesh
   (same model): the tight f64 runs of ``linear_solver='bsb'`` and
   ``'cg'`` against ``tests/data/golden_large_bsb_explicit.npz``, then the
   production settings of ``benchmarks/benchmark_large.py:118-125`` for
   both solvers in f64 and f32 (20 steps, no warm-up run: the tight runs
   warmed each solver's path, and the steps/s include the first run) with
   steps/s, Krylov and Newton iteration counts, kernel launches, and the
   trajectory and f32-vs-f64 errors against their gates; then one
   ``torch.profiler`` pass of the production bsb f64 run over its first 5
   steps (K4's share of device busy, the idle share) and the ms per
   BiCGStab iteration;
7. btd: the block-Thomas direct path on the 23.7k-dof RCM mesh (same
   model): the tight f64 run of ``benchmarks/benchmark_large.py:130-139``
   against ``tests/data/golden_large_btd_explicit.npz``, then the
   production settings of ``bench.py:411-434`` (bf16 factors, refresh 96,
   fixed-3 without the trailing residual, 100 steps after a warm-up run;
   replays of the captured step) in f64 and f32 with steps/s and the
   launch counts, each held by the reference's own gate (trajectory error
   <= 5e-7 against the exact-Jacobian run of the same settings), and one
   ``torch.profiler`` pass of the production f64 run;
8. integrate: ``forward.integrate(model, None, ...)`` (the entry point a
   user calls, no statefile) on the M5 headline and the 23.7k production
   btd config, 100 steps, f64 and f32; then the eager loop and the
   captured step in turns (f64: eager, graph, graph; f32: eager, graph; no
   warm-up run, the entry point's run warms the path) with steps/s by
   CUDA events, each graph run held bit for bit (``torch.equal``) to the
   eager run with equal launch counts, the entry point's
   ``uncertified_steps`` and ``diverged`` equal to the eager run's, the
   graph's nodes a step, capture and instantiate ms and pool, a
   ``torch.profiler`` pass of each path over the first 10 steps (device
   kernels a step, device busy, idle share), the peak device memory of the
   eager loop and the graph (their first turns)
   and of the graph in windows of 25 steps, the gates of phases 5 and 7 on
   the graph's results, and the ms split of an eager btd step by CUDA
   events;
9. grad: the gradient path, ``adjoint.integrate_grad`` (value+grad of
   ``benchmarks/benchmark_adjoint.py``'s loss, sum(q[-20:]^2) 1e-6 over
   100 steps at dt = 1e-4; at M5 over its first 30), f64: at M5 with its
   adjoint settings (adaptive chord Newton, dense factors refreshed every
   25 steps) the forward and
   value+grad steps/s by CUDA events, the gradient overhead factor, and
   central differences along psub and a seeded random emod direction
   against the adjoint's directional derivative (rtol 1e-4); at 23.7k with
   the production adjoint settings (bf16 btd factors, refresh 16, fixed-3)
   the same timings, the refined stale-factor gradient against the
   exact-factor one (per key within 1e-6 of its largest entry), the
   launches a step of K1, K2, K5, K5T, K6 and K6T held to the trace of a
   profiled value+grad run over the first 10 steps, its idle share, and
   the peak device memory; on both every
   gradient is finite and the value+grad run's trajectory is the no-grad
   forward's bit for bit (the captured graph's at 23.7k);
10. tangents: at 23.7k in f64, the 'cg' and 'bsb' value+grad (tight
   Krylov settings, 10 steps of the same loss; a transposed BiCGStab solve
   on K3T / K4T each step) against the exact btd gradient (per group within
   1e-6), with steps/s and K3T/K4T launches a step held to a profiled
   run's trace; ``forward.integrate_linear_pure`` (bf16 btd factors,
   refresh 1) in duality with ``adjoint.integrate_grad`` along emod and
   psub (rtol 1e-8); ``parameters.TractionShape`` on the card (banded:
   its certificate ``|K umesh - T t| / |T t|`` with K applied by K4, jvp
   linearity, vjp duality) and the composed shape gradient
   (KelvinVoigtWShape + BernoulliSmoothMinSep, ``integrate_grad`` with
   respect to umesh, then ``apply_vjp``) against a central difference;
11. implicit: the implicit (Picard) coupling and the static solvers. The
   implicit leg of ``bench.py`` (M5-3layers, KelvinVoigtWEpithelium +
   BernoulliSmoothMinSep, dense factors refreshed every 25 steps,
   stagnation ratio 0.5, Aitken; 100 steps at dt = 1e-4) in f64 against
   ``tests/data/golden_m5_implicit.npz`` (u every 10 steps and the final
   q within 1e-7 of max|x|; Picard counts beside the golden's) and in f32
   (within 10x the JAX package's f32-vs-f64 difference at the end and at
   each stored step before the reference run stops converging, step 15),
   with steps/s by CUDA events (no warm-up run: the first run's), Picard
   and solid Newton iterations a step, K1/K2/K5 launches a step and a
   ``torch.profiler`` pass over the first 5 steps; at 23.7k the same model on the production
   btd settings plus Aitken (12 steps) against its exact-Jacobian implicit
   run (5e-7) with K6's launches; the 23.7k static configuration of the
   Hopf leg (``static.static_coupled_configuration_picard``, KelvinVoigt,
   psub 500 Ba, static btd Newton) against the golden's (1e-6), timed,
   and one backward of ``solve_static_u1`` there (K6T); M5 implicit
   value+grad over 14 steps (the coupled IFT rule's dense Jacobian) against
   a central difference in psub (rtol 1e-4), with its peak device memory;
12. fsai: two-way fluid-solid-acoustic coupling (``models.fsai``,
   ``load.load_fsai_model``). The M5 FSAI model of
   ``tests/make_golden_fsai.py`` (``meshes/M5_CB_GA3.msh``, KelvinVoigt +
   BernoulliAreaRatioSep, a 44-tube WRA tract, the contact plane below the
   midline; headline solver settings, 100 steps at the tract's dt) through
   ``forward.integrate`` (no lagged step) and then the eager loop and the
   captured step in turns (each graph run bit for bit the eager run), in
   f64 against ``tests/data/golden_m5_fsai.npz`` (rtol 1e-8) and in f32
   against the JAX package's f32 run (10x its f32-vs-f64 difference at each
   stored step), with steps/s, the step graph's nodes and replay time beside
   the uncoupled FSI step's at the same settings (what the flow root solve
   and the tract add: their share of the step), a profile of 10 graph steps
   (device busy, idle share) and the peak device memory; the 23.7k
   production btd model in the same tract on the production settings, f64
   and f32, against its exact-Jacobian FSAI run (trajectory error <= 5e-7,
   no lagged step), with K6's launches; and value+grad
   (``adjoint.integrate_grad``) of the RMS radiated pressure
   (``functional.acoustic``) over 50 steps, the value the no-grad
   forward's bit for bit: at M5 against central differences in psub and
   along a seeded direction of tract areas (rtol 1e-4), at 23.7k on the
   production adjoint settings (K6T) against the exact-factor gradient;
13. mesh94k: the 94.8k-dof mesh (``m5_mesh("M5_3layers", h=0.003,
   smooth_iters=10)`` and RCM, ``vf_fem_tpu_torch/mesh/cached.py``), built
   by a child process started after the kernels' build that runs beside
   phases 2-12 and caches it in ``vf_fem_tpu_torch/_build/`` (a later run
   on the same machine reads the cache): its vertex and cell counts
   (47,405 / 93,945), then the production btd settings at refresh 64 (the
   JAX package's margin configuration) on it, 100 steps in f64 and f32 (a
   replay of the captured step a step), the f64 run against its
   exact-Jacobian run (the trajectory error gated at 5e-7), with
   steps/s, a step's split (one refactorization's time), a profile of 10
   steps and the peak device memory;
14. hopf: linear stability (``misc.hopf``, ``models.dynamical``,
   ``solvers.cbtd``). The Hopf leg of ``bench.py:533-575`` at 23.7k
   (``M5_3layers_rcm_h006.msh``, KelvinVoigt + BernoulliSmoothMinSep with
   the leg's properties; sigma = 2 pi 120 i, arnoldi_m 70, the static
   solve on btd; f64 factors) at psub 500 then 1000 Ba: each point's
   seconds and its parts by CUDA events (static solve, pencil assembly,
   complex factorization, the nf coupling solves, Arnoldi, certificate),
   the leading mode, ``n_conv``, the largest certificate, K4 and K6
   launches and the peak memory, every returned mode certified and within
   1e-5 max(|lambda|, 1) of the JAX package's f64 CPU run
   (``tests/data/golden_hopf_23k.npz``) or its conjugate; K6 at the
   embedded width 2Bt = 512 on the point's factors (f64, and f64 factors
   stored f32), forward and backward, held row by row and as a whole to
   its plain version, and its call and device time against its bound; the
   psub 500 point with f32 factors (refined twice) against the f64 one at
   ``tests/test_hopf.py:254-265``'s gates, its seconds beside f64's;
   M5-3layers (RCM) dense QZ (the pencil assembled on the card before
   phase 2, ``misc.hopf.dense_pencil``; its QZ, ``misc.hopf.qz_modes``,
   in a child process on the host beside phases 2-13) against the banded
   solver on the card at ``tests/test_hopf.py:176-203``'s gates;
15. physics: the solid residuals and fluids of slice 7 on the main path
   (``PHYSICS_*``; the banded cell pass K1/K2 runs each new element
   kernel, K5 and K6 carry the step).  M5-3layers:
   SwellingKelvinVoigtWEpithelium + BernoulliFixedSep and Rayleigh +
   BernoulliFlowFixedSep (qsub-driven), 100 steps at dt 1e-4 on the
   headline settings in f64, every eighth u, all q and the final p within
   1e-8 of the JAX package's f64 CPU run
   (``tests/data/golden_m5_physics.npz``), its Newton counts, the
   uncertified steps beside the JAX run's and steps/s; 23.7k: the swelling
   model on the production btd settings in f64 and f32 (graph and eager
   steps/s, the step graph's replay ms and nodes a step, K1/K2/K5/K6
   launches a step, uncertified steps) against its exact-Jacobian run
   (``TRAJ_ERR_GATE``, or 1.5x the JAX package's own value where that is
   over; ``tests/data/golden_physics_23k.npz``), the f64 final u against
   the JAX package's, each beside phase 7-8's KelvinVoigtWEpithelium run;
16. api: the stateful model API and the post-processing (``set_*``,
   ``solve_state1``, ``assem_*``; ``postprocess``, ``misc.signal``), f64.
   The M5 CAD golden's 80 steps through ``solve_state1`` /
   ``set_ini_state`` against ``golden_m5cad_explicit.npz`` (rtol 1e-8) and
   the eager loop (bit-equality reported), with ms a step of both;
   M5-3layers' ``assem_res`` and block derivatives ``assem_dres_dstate1``
   / ``_dstate0`` / ``_dcontrol`` on the card against the CPU's (1e-12 of
   each block's largest entry), their Taylor remainders (order >= 1.9
   where the residual is not affine: the state1 derivative, with the
   contact penalty engaged), the ``solve_dres_dstate1`` round trip and the
   adjoint's duality; 5 steps of ``solve_state1`` at 23.7k with 'btd',
   'bsb' and 'cg' each against the eager loop on the same settings at
   refresh 1, with K6, K4 and K3 launched beside K1/K2/K5; ``TimeSeries``
   of 19 measures over phase 8's 23.7k production run (in memory,
   ``RunReader``) on the card against its per-state loop and the CPU's
   series; phonation: the M5 CAD model at psub 6000 Ba, 1,200 steps on the
   headline settings in the step graph, the minimum glottal width's f0
   and series against the JAX package's f64 CPU run
   (``tests/data/golden_phonation_m5.npz``);
17. 3d: extruded 3D (P1 tetrahedra, one fluid channel a z-plane). The
   small extruded stack (``EXTRUDED_SMALL``: M5_CB_GA3 at h 0.1 through 3
   planes, 477 dofs) dense with the exact Jacobian and banded btd
   (refresh 6, fixed-3, f64 and bf16 factors), 12 steps against the JAX
   package's f64 CPU runs (``tests/data/golden_3d.npz``); the 45.8k-dof
   fold (``MESH3D``, ``benchmarks/benchmark_large.py``'s
   ``build_model(0.015, nz=8)``: 15,272 vertices, 76,419 tetrahedra, 8
   channels; meshed by a child process started after the kernels' build,
   and held to the JAX package's mesher's mesh: its ``mesh_digest`` and
   coords in ``tests/data/golden_3d_45k.npz``): K1/K2 and their VJPs on
   its plan (nv = 4, 16 channels gathered, 3 scattered), K3 (nld = 12)
   and K4 (h = 10) on its Jacobian and K6 at Bt = 1280 (36 row blocks) on
   its own factors in the four dtype pairs,
   each against its plain version and timed as in phases 2-3; its first 5
   tight f64 btd steps against ``tests/data/golden_3d_45k.npz``; the
   production btd settings in f64 and f32 (100 steps, a replay of the
   captured step a step, the f64 run bit for bit the eager loop's) against
   their exact-Jacobian runs (``TRAJ_ERR_GATE``, or 1.5x the JAX
   package's own value where that is over), with steps/s, launches a step,
   graph nodes a step, one refactorization's ms, the peak device memory
   and a profile of the f64 run (idle share);
18. dd: SPIKE and the DOF-sharded step (``solvers.spike``,
   ``parallel.ddstep``; the shards stacked on the card).  K6 over slabs
   (one cluster a slab) on the 23.7k model's own SPIKE factors, 8 slabs of
   12 row blocks in bf16/f64, f64/f64 and f32/f32 and 4 and 16 slabs in
   f64 (16 clusters of 16 CTAs run in waves), each slab's sweeps held row
   by row and as a whole to the plain version and bit for bit to one
   launch a slab, timed beside those separate launches; bench.py's
   production settings with ``linear_solver='spike'`` (8 partitions, f64,
   100 steps) eagerly and in the step graph (bit-equal), its trajectory
   error against phase 7's exact-Jacobian btd run (5e-7) and steps/s
   beside phase 8's btd graph; the DD step over 8 shards at 23.7k
   (``assembly`` 'banded' and 'plain', f64 factors, refresh 8, adaptive
   Newton, 20 steps) against the single-device run (max|du| < 1e-10
   max|u|, q at rtol 1e-9) and 'banded' against 'plain' (1e-9), with
   steps/s, peak memory and launches a step; K1/K2 on the stacked
   per-shard plans of that partition and their VJPs against the plain
   versions in f64 and f32, timed beside ``index_select`` and a
   block-diagonal ``sparse.mm``;
19. sweep: batched parameter sweeps (``parallel.sweep``, BASELINE config
   5).  bench.py's sweep leg (64 variants of M5 geometry and stiffness x
   50 steps, its settings ``tol_s``) in 'plain' and in 'banded' assembly:
   the batched eager loop and the replayed graph of the batched step
   (bit-equal), variant-steps/s of each, peak memory, the idle share of a
   profiled graph run, launches a batched step (one K5 for the batch, and
   in 'banded' as many K1/K2 as one variant's run); 'banded' within 1e-12
   of 'plain'; rows 0, 31 and 63 against their variants run alone (rtol
   1e-10); rows 0, 9, ..., 63 against the JAX package's f64 CPU run
   (``tests/data/golden_sweep_m5.npz``, rtol 1e-8); BASELINE config 5, 256
   x 100, the same figures; ``sweep_grad`` over 8 x 20 (adaptive), a
   variant's shape gradient against central differences.  Phase 3 holds
   K5 and K5T over batches of 8, 64 and 256 M5 vectors (K5T a CTA a
   variant, a row cotangent a variant) to their plain versions, and times
   them with their inputs cold in L2 (``graph_ms_cold``).

Phase 3 also holds the block-Thomas sweep kernel (K6) and its transpose
(K6T, both sweeps of ``btd_solve_t``: forward on W, backward on V, each
the same bits in three launches) against their plain versions on the
23.7k model's own factors, holds K6's launch plan
(``ops.sweep_plan``) to the one compiled into ``csrc/btd.cu`` for every
width and dtype pair, prints the plan (cluster size, ring depth) and K6's
time per row block, and times its exchange of the carried vector alone
(``csrc/btd_exchange_probe.cu``: st.async on mbarriers against
barrier.cluster); phase 7 prints K6's share of the profiled device time.

Phases 2 and 3 time every kernel four ways, by CUDA events: its call time
(the eager call, which the main path pays), its device time (200 launches
captured in one CUDA graph and replayed), its plain version, and, where
one PyTorch call computes the same function (``vf_fem_tpu_torch.yardsticks``:
``index_select`` for K1, ``sparse.mm`` for K2, K4 and K4T), that call, in turns
with the kernel (library, kernel, kernel, library), and that call's device
time in a CUDA graph, as the kernel's.  Each kernel's bound
is the larger of its bytes (each input read once, each output written
once) over the HBM rate and its operations over the peak rate of their
type.  The ``kernels`` line before the last carries all of it, with each
kernel's launches per step on the main-path runs (phases 5-19; a Hopf
point counts as one step).

Phases 5-7 print each production run's Newmark predictors, taken from
K5's output or formed by four eager kernels, and each profile's device
kernels a step beside the eager loop's earlier figure (PERF.md section
5).  The launch and predictor counts add a captured step's counts at each
replay (``step_graph``); phases 5, 7 and 8 hold each kernel's count in a
profiled run to its launches in the profiler's trace.

Every phase raises on failure, so the script exits nonzero; on success its
last line is ``{"ok": true, "device": {...}}``.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LARGE_MESH = "M5_3layers_rcm_h006.msh"
N_STEPS = 100
MEMORY_WINDOW = 25  # steps a window of integrate's, where phase 8 reads peak memory
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
# tests/make_golden_large_bsb.py: the tight settings of the golden, and
# the production settings of benchmarks/benchmark_large.py:118-125
TIGHT = {
    "assembly": "banded",
    "krylov_tolerance": 1e-10,
    "krylov_max_iter": 1000,
    "jacobian_refresh_steps": 1,
}
PROD = {
    "assembly": "banded",
    "krylov_tolerance": 1e-4,
    "krylov_max_iter": 200,
    "jacobian_refresh_steps": 8,
    "stagnation_ratio": 0.5,
}
# name, TPU kernel replaced, source, counter
KERNELS = {
    "gather": ("banded_gather", "vf_fem_tpu/fem/banded.py:174",
               "vf_fem_tpu_torch/csrc/banded.cu"),
    "scatter": ("banded_scatter", "vf_fem_tpu/fem/banded.py:191",
                "vf_fem_tpu_torch/csrc/banded.cu"),
    "ebe_matvec": ("ebe_matvec", "vf_fem_tpu/ops/pallas_kernels.py:36",
                   "vf_fem_tpu_torch/csrc/ops.cu"),
    "bsb_matvec": ("bsb_matvec", "vf_fem_tpu/ops/pallas_kernels.py:97",
                   "vf_fem_tpu_torch/csrc/ops.cu"),
    "newmark": ("newmark_update", "vf_fem_tpu/ops/pallas_kernels.py:153",
                "vf_fem_tpu_torch/csrc/ops.cu"),
    "btd_sweep": ("btd_sweep", "none (lax.scan, vf_fem_tpu/solvers/btd.py:298-312)",
                  "vf_fem_tpu_torch/csrc/btd.cu"),
    "newmark_t": ("newmark_update_t", "none (K5's backward; the JAX package differentiates"
                  " vf_fem_tpu/equations/newmark.py:21-72)", "vf_fem_tpu_torch/csrc/ops.cu"),
    "btd_sweep_t": ("btd_sweep_t", "none (lax.scan, vf_fem_tpu/solvers/btd.py:340-358)",
                    "vf_fem_tpu_torch/csrc/btd.cu"),
    "ebe_matvec_t": ("ebe_matvec_t", "none (XLA einsum, vf_fem_tpu/fem/assembly.py:255-278)",
                     "vf_fem_tpu_torch/csrc/ops.cu"),
    "bsb_matvec_t": ("bsb_matvec_t", "none (XLA, vf_fem_tpu/solvers/bsb.py:168-188)",
                     "vf_fem_tpu_torch/csrc/ops.cu"),
    "gather_t": ("banded_gather_t", "vf_fem_tpu/fem/banded.py:445",
                 "vf_fem_tpu_torch/csrc/banded.cu"),
    "scatter_t": ("banded_scatter_t", "vf_fem_tpu/fem/banded.py:470",
                  "vf_fem_tpu_torch/csrc/banded.cu"),
    "btd_sweep_slabs": ("btd_sweep over slabs", "none (lax.scan, vf_fem_tpu/solvers/spike.py:172-199)",
                        "vf_fem_tpu_torch/csrc/btd.cu"),
    # K5 and K5T at the batch shapes that phase 19's runs give them (M5's
    # 960 dofs): K5 at 64 and 256 variants (the sweeps) and at 8 (the
    # gradient sweep's forward), K5T at 8 (its backward); each batch one
    # launch
    "newmark x8": ("newmark_update over a batch of 8", "vf_fem_tpu/ops/pallas_kernels.py:153",
                   "vf_fem_tpu_torch/csrc/ops.cu"),
    "newmark x64": ("newmark_update over a batch of 64", "vf_fem_tpu/ops/pallas_kernels.py:153",
                    "vf_fem_tpu_torch/csrc/ops.cu"),
    "newmark x256": ("newmark_update over a batch of 256",
                     "vf_fem_tpu/ops/pallas_kernels.py:153", "vf_fem_tpu_torch/csrc/ops.cu"),
    "newmark_t x8": ("newmark_update_t over a batch of 8", "none (K5's backward; the JAX"
                     " package differentiates vf_fem_tpu/equations/newmark.py:21-72 under vmap)",
                     "vf_fem_tpu_torch/csrc/ops.cu"),
}
# the launch counter of a row of KERNELS whose key is not its counter's
KERNEL_COUNTER = {"newmark x8": "newmark", "newmark x64": "newmark", "newmark x256": "newmark",
                  "newmark_t x8": "newmark_t"}

# benchmarks/benchmark_adjoint.py:68-88: the value+grad settings at M5 (the
# accelerator branch: adaptive chord Newton, dense factors refreshed every
# 25 steps) and at 23.7k (bf16 btd factors, refresh 16, fixed-3), and its
# loss over 100 steps at dt = 1e-4 (:89-94)
ADJ_M5 = {
    "stagnation_ratio": 0.5,
    "jacobian_update": "once_per_step",
    "jacobian_refresh_steps": 25,
    "jacobian_refresh_mode": "ns",
    "jacobian_full_refresh_windows": 4,
}
ADJ_LARGE = {
    "assembly": "banded",
    "linear_solver": "btd",
    "btd_store_dtype": "bfloat16",
    "jacobian_refresh_steps": 16,
    "fixed_iterations": 3,
    "stagnation_ratio": 0.5,
}
# central differences of the M5 loss against the adjoint's directional
# derivative (psub by 1 Ba as tests/test_adjoint.py:55-63; emod along a
# seeded random direction of 5 Ba a cell, 1e-4 of emod)
FD_RTOL = 1e-4
# the refined stale-factor gradient against the exact-factor one at 23.7k:
# max|g_stale - g_exact| / max|g_exact| per key (the refinement stops at
# 1e-8 of |u1_bar| each step)
STALE_VS_EXACT = 1e-6
# the M5 value+grad and its central differences over the loss's first 30
# steps (the adjoint against central differences of the same loss: a gate
# that holds at any depth)
GRAD_M5_STEPS = 30
# phase 10: steps of its runs at 23.7k (dt = 1e-4), the profiled steps of
# its Krylov value+grad runs, and its gates: the 'cg' and 'bsb' gradients
# (TIGHT, a transposed BiCGStab solve each step) against the exact btd one,
# per group max|g - g_btd| / max|g_btd|; the duality <h, J x_dot> = <J^T h,
# x_dot> of integrate_linear (forward mode) and integrate_grad (reverse);
# TractionShape's solve certificate |K umesh - T t| / |T t|, its jvp's
# linearity and its vjp duality (tests/test_functional.py:304-356); the
# composed shape gradient against a central difference
TANGENT_STEPS = 10
TANGENT_PROFILE_STEPS = 3
KRYLOV_VS_EXACT = 1e-6
BTD_EXACT_GRAD = {"assembly": "banded", "linear_solver": "btd",
                  "jacobian_refresh_steps": 1, "adjoint_refine": "exact"}
LINEAR_BTD = {"assembly": "banded", "linear_solver": "btd", "btd_store_dtype": "bfloat16",
              "jacobian_refresh_steps": 1}
DUALITY_RTOL = 1e-8
CERTIFICATE_GATE = 1e-10
TRANSFORM_LINEAR_RTOL = 1e-7
TRANSFORM_DUALITY_RTOL = 1e-9
SHAPE_FD_RTOL = 1e-4
SHAPE_PARAMS = {"assembly": "banded", "linear_solver": "btd", "jacobian_refresh_steps": 1}
SHAPE_TIMES = 2e-5 * np.arange(6)  # tests/test_functional.py:411
# benchmarks/benchmark_large.py:130-139: the tight btd settings of the
# golden_large_btd_explicit.npz run
BTD_TIGHT = {
    "assembly": "banded",
    "linear_solver": "btd",
    "jacobian_refresh_steps": 16,
    "fixed_iterations": 3,
    "stagnation_ratio": 0.5,
}
# bench.py:411-434, the production large-mesh settings
BTD_PROD = {
    "assembly": "banded",
    "linear_solver": "btd",
    "btd_store_dtype": "bfloat16",
    "jacobian_refresh_steps": 96,
    "fixed_iterations": 3,
    "fixed_tail_residual": False,
    "stagnation_ratio": 0.5,
}
# bench.py:459-466: its exact-Jacobian comparison run
BTD_EXACT = {**{k: v for k, v in BTD_PROD.items() if k != "btd_store_dtype"},
             "jacobian_refresh_steps": 1}
TRAJ_ERR_GATE = 5e-7  # bench.py:454-473
# The tight btd run against golden_large_btd_explicit.npz: max|x_port -
# x_golden| / max|x_golden| of u (every 10 steps) and of the final v, a,
# q, p, gated at 10x the port's own difference on a CPU (x86-64, plain
# versions: u 7.457e-16, v 6.532e-14, a 2.127e-11, q 0, p 1.253e-15),
# floored at 1e-14 (~50 f64 ulps) where that difference is exact or near it
GOLDEN_BTD_GATES = {"u": 1e-14, "v": 6.532e-13, "a": 2.127e-10, "q": 1e-14,
                    "p": 1.253e-14}
# the production f64 run's final u against the JAX package's (the golden's
# prod_u_final): 10x the port's difference on a CPU, 2.656e-8
PROD_U_GATE = 2.656e-7
# K6 against the plain sweep, whole sweeps (the row-by-row check is the
# exact gate): 100x the difference between two summation orders of the
# plain sweep on the 23.7k factors, measured on a CPU (x86-64): 3.3e-16
# (f64 factors), 1.1e-7 (f32 sums)
SWEEP_FULL_GATES = {"float64": 1e-13, "float32": 1e-5}
# Tight runs against the large golden: max|x_port - x_golden| / max|x_golden|
# of u (every 5 steps) and of the final v, a, q, p.  The final acceleration
# a = 4 (u1 - u0 - dt v0) / dt^2 - a0 amplifies the 1e-10 Krylov tolerance
# in u: the port on a CPU (x86-64, plain versions) differs from the
# golden in a by 5.405e-09 (bsb) and 2.090e-08 (cg), so each solver's a is
# gated at 10x its own difference; the other fields at 1e-8
GOLDEN_LARGE_GATES = {
    ls: {"u": 1e-8, "v": 1e-8, "a": a_gate, "q": 1e-8, "p": 1e-8}
    for ls, a_gate in (("bsb", 5.405e-8), ("cg", 2.090e-7))
}
WARMUP, REPS = 20, 200
# steps of the profiled runs of phases 8, 9, 12 and 13 (by
# ``key_averages()`` an eager step's host events cost ~0.6 s each to
# summarise, a value+grad step's ~3.4 s: the profiles took 351 s of a 916 s
# run at 25 steps on an H100, so the window is 10 steps; ``device_events``
# now reads the raw trace instead; counts a step are read from these runs)
PROFILE_STEPS = 10
# device kernels a step in the eager loop's f64 profiles of each run
# (PERF.md section 5), printed beside this run's
# each launch counter's kernel, by the name the profiler's trace gives it
TRACE_NAMES = {"gather": "banded_gather_kernel", "scatter": "banded_scatter_kernel",
               "newmark": "newmark_kernel", "btd_sweep": "btd_sweep_kernel",
               "ebe_matvec": "ebe_matvec_kernel", "bsb_matvec": "bsb_matvec_kernel",
               "newmark_t": "newmark_t_kernel", "btd_sweep_t": "btd_sweep_t_kernel",
               "ebe_matvec_t": "ebe_matvec_t_kernel", "bsb_matvec_t": "bsb_matvec_t_kernel"}
EARLIER_PER_STEP = {"M5 headline": 811.0, "23.7k btd": 887.5, "23.7k bsb": 8651.0}
# phase 11, implicit coupling: the implicit leg of bench.py (its settings,
# :493-497; its model, build_implicit :787-822) at M5 against
# tests/data/golden_m5_implicit.npz (u every 10 steps and the final q,
# max|du|/max|u|); the 23.7k run on the production btd settings
# (:411-434) with Aitken, gated against the exact-Jacobian implicit run
# (no bf16 storage, refresh 1) by the reference's trajectory gate; the Hopf
# leg's static configuration (:533-575: KelvinVoigt, psub 500 Ba, static
# Newton on block-Thomas solves) against the golden's; and value+grad of
# the M5 implicit run through the coupled IFT rule against a central
# difference in psub
IMPLICIT = {"jacobian_refresh_steps": 25, "stagnation_ratio": 0.5, "aitken": True}
IMPLICIT_BTD = {**BTD_PROD, "aitken": True}
IMPLICIT_BTD_EXACT = {**BTD_EXACT, "aitken": True}
IMPLICIT_GOLDEN_GATE = 1e-7
# steps of the 23.7k implicit runs: on this model the Picard loop stops
# converging at step 13 and the state goes non-finite at step 15, in the
# JAX package's run as in the port's (tests/probe_implicit_breakdown.py)
IMPLICIT_LARGE_STEPS = 12
STATIC_OPTIONS = {"linear_solver": "btd"}
STATIC_PSUB = 500.0
STATIC_GOLDEN_GATE = 1e-6
# value+grad steps: the bench leg's model stops converging at step 15 (its
# glottal area turns negative at step 16: the contact plane lies above the
# midline), where the IFT rule, which assumes a root, is no derivative of
# the run; at 20 steps the gradient is 9.4% off its central difference in
# the JAX package and in the port alike, at 14 1.4e-6
# (tests/probe_implicit_breakdown.py)
IMPLICIT_GRAD_STEPS = 14
# steps of phase 11's profiled M5 run: ``key_averages()`` took 94.5 s to
# summarise 25 eager implicit steps (181,224 device kernels) and 62.3 s for
# 10 (108,676; NVIDIA H100 80GB HBM3, 700.00 W), so the phase profiles the
# first 5
IMPLICIT_PROFILE_STEPS = 5
# phase 12, fluid-solid-acoustic coupling (FSAI).  M5: the model of
# tests/make_golden_fsai.py (benchmarks/probe_fsai.py:33-65, the contact
# plane at ymax + 0.005 below the midline ymid = ymax + 0.01; its
# configuration is stored in the golden) on the M5 headline's settings,
# 100 steps at the tract's dt, f64 against the golden and f32 against the
# JAX package's f32 run within 10x its own f32-vs-f64 difference at each
# stored step (phase 11's f32 tolerance); 23.7k: the production btd model in
# the same tract, the same contact plane, on BTD_PROD against its
# exact-Jacobian FSAI run (TRAJ_ERR_GATE, or 1.5x the JAX package's CPU
# value of the same runs where that exceeds it, as phase 7: the golden's
# large_traj_err, large_f32_traj_err); value+grad of the RMS radiated
# pressure over 50 steps of the M5 model (ADJ_M5) against central
# differences in psub (1 Ba) and along a seeded direction of tract areas
# (1e-4 cm^2 a tube)
FSAI_GOLDEN_RTOL = 1e-8
FSAI_GRAD_STEPS = 50
FSAI_AREA_H = 1e-4
# phase 13: the 94.8k-dof mesh of benchmarks/benchmark_large.py:24-51
# (m5_mesh("M5_3layers", h=0.003, smooth_iters=10) then RCM), meshed by a
# child process started with the phases (vf_fem_tpu_torch/mesh/cached.py,
# cached in vf_fem_tpu_torch/_build/), its expected size, and the JAX
# package's refresh-64 margin configuration (STATUS.md:360), gated in f64
# against its exact-Jacobian run
MESH94K = ("M5_3layers", 0.003, 10)
MESH94K_COUNTS = (47405, 93945)
BTD_R64 = {**BTD_PROD, "jacobian_refresh_steps": 64}
# phase 14: the Hopf leg of bench.py:533-575 (KelvinVoigt +
# BernoulliSmoothMinSep with the leg's properties, psub 500 then 1000 Ba,
# sigma = 2 pi 120 i, arnoldi_m 70, static Newton on btd solves) at 23.7k
# with f64 factors, its modes against the JAX package's f64 CPU run
# (tests/data/golden_hopf_23k.npz) within the banded-vs-dense gate of
# tests/test_hopf.py:176 (1e-5 max(|lambda|, 1)); the same point with f32
# factors against it at tests/test_hopf.py:254-265's gates; M5-3layers
# (RCM) dense QZ against the banded solver at tests/test_hopf.py:176-203's
# gates (psub 500 Ba, arnoldi_m 60)
HOPF_PROPS = dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, kcontact=1e8, rho_air=1.1225e-3,
                  zeta_min=1e-3, zeta_sep=1e-3)
HOPF_ARGS = dict(solver="banded", sigma=1j * 2 * np.pi * 120.0, arnoldi_m=70,
                 static_options={"linear_solver": "btd"}, return_info=True)
HOPF_PSUBS = (500.0, 1000.0)
HOPF_GOLDEN_TOL = 1e-5
HOPF_M5_PSUB = 500.0
HOPF_M5_M = 60
# phase 15, physics: the residuals and fluids of slice 7 through the main
# path.  M5 (meshes/M5_3layers.msh, 960 dofs): SwellingKelvinVoigtWEpithelium
# + BernoulliFixedSep (psub-driven) and Rayleigh + BernoulliFlowFixedSep
# (flow-driven), 100 steps at dt 1e-4 on HEADLINE in f64, every eighth u,
# all q and the final p within PHYSICS_GOLDEN_RTOL of the JAX package's f64
# CPU run (tests/data/golden_m5_physics.npz); 23.7k: the swelling model on
# BTD_PROD in f64 and f32 against its exact-Jacobian run (TRAJ_ERR_GATE, or
# 1.5x the JAX package's CPU value of the same runs where that exceeds it,
# tests/data/golden_physics_23k.npz), and the f64 final u against the JAX
# package's within PHYSICS_U_GATE.  Both goldens: python
# tests/make_golden_physics.py.  The values: bench.py's properties; the new
# residuals' of tests/test_matrix.py:35-54, with the swelling volume of its
# end-to-end runs (1.02, :134-137) at M5 and its default (1.0) at 23.7k;
# separation at the interface position of the mesh's 'separation-inf'
# vertex; the midline 0.05 above the medial surface's peak with the contact
# plane 0.01 below it; psub 4000 Ba at M5 and 1000 Ba at 23.7k, qsub 100
# cm^2/s.  Elsewhere these models leave the glottis or diverge in the JAX
# package's own runs (tests/probe_physics_config.py; PERF.md section 6):
# at M5 with bench.py's gap (the midline 0.01 above the peak, the
# contact plane 0.04 beyond it), and the swelling model also with psub 8000
# Ba or with separation at 'separation-sup' (max|u| 6.8-94 cm); at 23.7k
# with a swelling volume of 1.02 (the exact-Jacobian run non-finite from
# step 14-18 at psub 500-1000), and the production run from psub 1500 on
# (non-finite from step 82-98)
PHYSICS_M5 = {"swelling": ("SwellingKelvinVoigtWEpithelium", "BernoulliFixedSep"),
              "rayleigh": ("Rayleigh", "BernoulliFlowFixedSep")}
PHYSICS_LARGE = ("SwellingKelvinVoigtWEpithelium", "BernoulliFixedSep")
PHYSICS_PROPS = dict(v_swelling=1.02, m_swelling=0.0, k_swelling=1e4, rayleigh_m=1.0,
                     rayleigh_k=1e-4, u_ant=0.0, u_pos=0.0, length=1.0, muscle_stress=0.0)
PHYSICS_LARGE_PROPS = {**PHYSICS_PROPS, "v_swelling": 1.0}
PHYSICS_CONTROLS = {"psub": 4000.0, "qsub": 100.0, "psup": 0.0}
PHYSICS_LARGE_CONTROLS = {**PHYSICS_CONTROLS, "psub": 1000.0}
PHYSICS_SEPARATION = "separation-inf"
PHYSICS_YMID_ABOVE_YMAX = 0.05
PHYSICS_YCONTACT_ABOVE_YMAX = 0.04
PHYSICS_GOLDEN_RTOL = 1e-8
# the 23.7k production f64 run's final u against the JAX package's
# (max|du| / max|u|): 10x the port's difference on a CPU (x86-64, plain
# versions), 4.408e-8, as PROD_U_GATE (the bf16 factors round the two
# packages' stale chord iterates apart)
PHYSICS_U_GATE = 4.408e-7
# csrc/btd_exchange_probe.cu's entry points: (sink, n, bt, barrier, stream)
# phase 16, the stateful API and the post-processing.  Phonation: the M5
# CAD golden's model (KelvinVoigtWEpithelium + BernoulliAreaRatioSep,
# bench.py's properties) at psub 6000 Ba, the configuration of the
# self-oscillation STATUS.md:506-510 reports (f0 100.0 Hz, TPU f32), 1,200
# steps at dt 5e-5 on the headline settings; f0 by rfft over the steady
# two thirds of the minimum glottal width (tests/make_golden_phonation.py
# writes the JAX package's f64 CPU run of it)
PHONATION = {"mesh": "M5_CB_GA3.msh", "solid": "KelvinVoigtWEpithelium",
             "fluid": "BernoulliAreaRatioSep", "psub": 6000.0, "dt": 5e-5,
             "n_steps": 1200}
# phase 16: the derivative API's gates (tests/test_transient_api.py:98-119),
# its seeded solid state (the unit test's scales), the 23.7k stateful runs
# (each against the eager loop on the same settings at refresh 1) and the
# post-processing's measures (tests/test_functional.py:100-119)
API_CPU_REL = 1e-12
API_CONTACT_DEPTH = 0.01  # cm of the medial surface in contact
API_TAYLOR_ORDER = 1.9
API_ROUNDTRIP = dict(rtol=1e-6, atol=1e-8)
API_DUALITY_RTOL = 1e-9
API_EAGER_REL = 1e-12
API_LARGE_STEPS = 5
API_LARGE = {
    "btd": ({**BTD_EXACT}, "btd_sweep"),
    "bsb": ({**TIGHT, "linear_solver": "bsb"}, "bsb_matvec"),
    "cg": ({**TIGHT, "linear_solver": "cg"}, "ebe_matvec"),
}
API_MEASURES = (
    "StressI1Field", "StressI2Field", "StressVonMisesField", "StressHydrostaticField",
    "ElasticStressField", "StrainEnergy", "StrainEnergyRate", "ContactPressureField",
    "ViscousDissipationField", "ViscousDissipationRate", "ContactAreaDensity", "XMomentum",
    "YMomentum", "MeanGlottalWidth", "MidpointGlottalWidth", "MinGlottalWidthFromSolid",
    "FSIPressure", "FluidTractionPowerDensity",
)
SERIES_REL = 1e-12
PHONATION_GW_STEPS = 200
PHONATION_GW_REL = 1e-10
# phase 17, extruded 3D.  The small stack of tests/test_bsb.py:296-340
# (M5_CB_GA3 at h 0.1, 5 smoothing passes, extruded through 3 z-planes over
# 1.5 cm and RCM-ordered: 477 dofs, Bt 128; KelvinVoigt +
# BernoulliAreaRatioSep, psub 8000 Ba, 12 steps at dt 5e-5): its dense
# exact run and its btd runs (refresh 6, fixed-3, f64 and bf16 factors)
# against the JAX package's f64 CPU runs (tests/data/golden_3d.npz, python
# tests/make_golden_3d.py); the 45.8k-dof fold of
# benchmarks/benchmark_large.py's build_model(0.015, nz=8) (M5_3layers at
# h 0.015, 10 smoothing passes, 8 planes over 1.5 cm, RCM: 15,272 vertices,
# 76,419 tetrahedra, Bt 1280), bench.py's model and properties, its first 5
# tight f64 btd steps against tests/data/golden_3d_45k.npz (make_golden_3d.py
# --large) and the production btd settings in f64 and f32 against their
# exact-Jacobian runs
EXTRUDED_SMALL = {"profile": "M5_CB_GA3", "h": 0.1, "smooth_iters": 5, "nz": 3, "zlen": 1.5,
                  "solid": "KelvinVoigt", "fluid": "BernoulliAreaRatioSep", "psub": 8000.0,
                  "dt": 5e-5, "n_steps": 12}
EXTRUDED_SMALL_RUNS = {
    "dense": {"jacobian_refresh_steps": 1},
    "btd": {"assembly": "banded", "linear_solver": "btd", "jacobian_refresh_steps": 6,
            "fixed_iterations": 3},
    "btd16": {"assembly": "banded", "linear_solver": "btd", "btd_store_dtype": "bfloat16",
              "jacobian_refresh_steps": 6, "fixed_iterations": 3},
}
# the card against the JAX goldens, each field's max|d| / max|x|; the bf16
# run's trajectory against the dense exact run's at tests/test_bsb.py:352-353
GOLDEN_3D_RTOL = 1e-8
EXTRUDED_BF16_VS_DENSE = 1e-5
MESH3D = ("M5_3layers", 0.015, 10, 8, 1.5)  # profile, h, smoothing passes, planes, length
MESH3D_COUNTS = (15272, 76419)
MESH3D_BT = 1280
GOLDEN_3D_STEPS = 5
# the port's 45.8k mesh on the card against the JAX package's mesher's
# (golden_3d_45k.npz): mesh_digest exactly, the coords within this of their
# largest entry
MESH3D_COORDS_RTOL = 1e-12
PROBE_SIGNATURES = {f"vf_btd_exchange_probe_{t}": [ctypes.c_void_p] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] for t in ("bf16", "f64")}
# phase 19, batched sweeps (``parallel.sweep``): bench.py's sweep leg
# (:612-697; build_sweep :748-785, M5_3layers with KelvinVoigtWShape +
# BernoulliAreaRatioSep; per-variant umesh bump and emod 4e4 .. 6e4; its
# solver settings tol_s :656-664, assembly set by the run) at 64 variants x
# 50 steps in each assembly, BASELINE config 5 at 256 x 100 in the sweep's
# default assembly, and sweep_grad over 8 x 20 (default adaptive solver;
# test_parallel.py's loss); rows SWEEP_ALONE of the 64 against their
# variants run alone, the rows of tests/data/golden_sweep_m5.npz (the JAX
# package's f64 CPU run of the leg) at the M5 golden's rtol
SWEEP_PARAMS = {
    "jacobian_refresh_steps": 8,
    "jacobian_refresh_mode": "ns",
    "jacobian_full_refresh_windows": 8,
    "stagnation_ratio": 0.5,
    "fixed_iterations": 2,
    "jacobian_refresh_precision": "default",
}
SWEEP_LEG = (64, 50)
SWEEP_BASELINE = (256, 100)
SWEEP_GRAD = (8, 20)
SWEEP_ALONE = (0, 31, 63)
SWEEP_ALONE_RTOL, SWEEP_ALONE_ATOL = 1e-10, 1e-14  # tests/test_parallel.py:59-62 (u)
SWEEP_ALONE_VA = 1e-9  # v and a, of their max, once u's gap is taken out
SWEEP_GOLDEN_RTOL = 1e-8  # tests/test_golden.py:36-44
SWEEP_ASM_GATE = 1e-12  # 'plain' against 'banded': of max|u|
SWEEP_FD_H = 1e-6  # tests/test_parallel.py:297
SWEEP_PROFILE_STEPS = 16  # a profiled graph run: two refresh windows
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
L2_BYTES = 50 * 2**20  # H100 SXM data sheet
# peak rates outside the tensor cores (H100 SXM data sheet): f32 67
# TFLOP/s, f64 34 TFLOP/s; bf16 products accumulate in f32
PEAK_FLOP_S = {"float32": 67e12, "float64": 34e12}


def reset_launches():
    from vf_fem_tpu_torch import ops
    from vf_fem_tpu_torch.fem import banded

    for counts in (banded.LAUNCHES, banded.LAUNCHES_T, ops.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches():
    from vf_fem_tpu_torch import ops
    from vf_fem_tpu_torch.fem import banded

    return {**banded.LAUNCHES, **banded.LAUNCHES_T, **ops.LAUNCHES}


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


def cuda_ms(torch, fn, reps=REPS, warmup=WARMUP):
    """Mean time of ``fn()`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
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


def graph_ms(torch, fn, reps=REPS):
    """Device time of ``fn()``: ``reps`` calls captured once in a CUDA graph
    (after warm-up calls on a side stream), the mean over one replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms_cold(torch, fn, vecs, nbytes, reps=REPS):
    """Device time of ``fn(*vecs)`` with its inputs and outputs cold in L2:
    ``reps`` calls captured once in a CUDA graph, each on the next of as
    many copies of ``vecs`` as make the traffic between two calls on one
    copy at least twice the L2 (``nbytes`` a call), each call's outputs
    kept to the end of the capture (so that no call writes into lines an
    earlier call's outputs hold); the mean over one replay."""
    copies = max(2, -(-2 * L2_BYTES // nbytes))
    sets = [[v.clone() for v in vecs] for _ in range(copies)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % copies])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*sets[i % copies]) for i in range(reps)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del outs, graph
    return start.elapsed_time(end) / reps


def plain_ms(torch, plain):
    """Call time of a plain version: ``REPS`` calls, or as many as take
    about 0.2 s where one call takes over a millisecond (a plain sweep
    takes 5-16 ms), at least 10."""
    once = cuda_ms(torch, plain, reps=1, warmup=1)
    reps = max(10, min(REPS, int(200.0 / max(once, 1e-3))))
    return cuda_ms(torch, plain, reps=reps, warmup=min(WARMUP, reps // 10))


def measure(torch, kernel, plain, lib=None):
    """Call time of ``kernel`` (the mean of two runs taken in turns with the
    library call where there is one: library, kernel, kernel, library),
    its device time in a CUDA graph, the plain version's call time
    (``plain_ms``), and the library call's call time and its device time
    in a CUDA graph (``lib_device_ms``), read as the kernel's are."""
    lib_a = cuda_ms(torch, lib) if lib else None
    k_a, k_b = cuda_ms(torch, kernel), cuda_ms(torch, kernel)
    lib_b = cuda_ms(torch, lib) if lib else None
    return dict(ms=(k_a + k_b) / 2, ms_runs=(k_a, k_b), device_ms=graph_ms(torch, kernel),
                plain_ms=plain_ms(torch, plain),
                lib_ms=None if lib is None else (lib_a + lib_b) / 2,
                lib_runs=None if lib is None else (lib_a, lib_b),
                lib_device_ms=None if lib is None else graph_ms(torch, lib))


def bound_of(nbytes, flops, acc):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of the accumulation type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[acc] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bsb_work(pattern, ndof, itemsize):
    """K4's (bytes, operations) on its pattern (``solvers.bsb.MatvecPattern``):
    each value and its int32 offset, the int32 row pointers, x in and y
    out; a product and a sum an entry."""
    nnz = len(pattern.off)
    return nnz * (itemsize + 4) + (ndof + 1) * 4 + 2 * ndof * itemsize, 2 * nnz


def emulate_bsb(plan, pattern, blocks, x, lanes):
    """K4's output by ``tests/bsb_emulation.py`` (numpy, on the host): the
    kernel's summation order, to hold the kernel to bit for bit."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from bsb_emulation import emulate_bsb_matvec

    return emulate_bsb_matvec(plan, pattern, blocks, x, lanes)


def bsb_band_bytes(plan, itemsize):
    """The bytes of the Pallas contract: the whole dense band, x and y."""
    return (plan.nblk * plan.nb * plan.b * plan.b + 2 * plan.ndof) * itemsize


def fmt_times(r):
    lib = "" if r.get("lib_ms") is None else (
        f", {r['lib_call']} {r['lib_ms']:.6f} ms (runs {r['lib_runs'][0]:.6f},"
        f" {r['lib_runs'][1]:.6f}), its device {r['lib_device_ms']:.6f} ms")
    return (f"call {r['ms']:.6f} ms (runs {r['ms_runs'][0]:.6f}, {r['ms_runs'][1]:.6f}),"
            f" device {r['device_ms']:.6f} ms, plain {r['plain_ms']:.6f} ms{lib};"
            f" {r['bytes'] / 1e6:.3f} MB, bound {r['bound_ms']:.6f} ms ({r['bound_by']}),"
            f" device at {r['bound_ms'] / r['device_ms']:.1%} of it")


def phase_kernels(torch, dev):
    """K1/K2 and their VJPs against the plain versions (``banded_contracts``)
    on the M5-3layers plan and the 23.7k-dof RCM plan."""
    from vf_fem_tpu_torch.mesh import load_gmsh

    results = {}
    for label in ("M5_3layers", "M5_3layers_rcm_h006"):
        mesh = load_gmsh(os.path.join(REPO, "meshes", label + ".msh"))
        banded_contracts(torch, dev, label, mesh, results, "kernels")
    return results


def banded_contracts(torch, dev, label, mesh, results, tag_line):
    """K1/K2 and their VJPs against the plain versions on ``mesh``'s banded
    plan, in f64 and f32, at the channel counts of the KelvinVoigtWEpithelium
    main path: 5 dim + 1 gathered channels (a1, u1, v1, p1, tcontact, X: 11
    in 2D, 16 in 3D), dim scattered (the residual); timed, with their
    library calls, into ``results[(label, dtype, op)]``."""
    from vf_fem_tpu_torch import config, yardsticks
    from vf_fem_tpu_torch.fem import banded

    nvert = mesh.num_vertices
    ng, ns = 5 * mesh.dim + 1, mesh.dim
    hp = banded.plan_banded(mesh.cells, nvert, gc=config.BANDED_GC)
    dp = banded.to_device(hp, dev)
    log(f"[{tag_line}] {label}: {nvert} vertices, {mesh.num_cells} cells, nv={dp.nv},"
        f" ngroups={dp.ngroups} gc={dp.gc} w={dp.w} nvert_pad={dp.nvert_pad};"
        f" {ng} channels gathered, {ns} scattered")
    rng = np.random.default_rng(0)
    host = dict(
        F=rng.standard_normal((ng, nvert)),
        loc=rng.standard_normal((dp.nv, ns, dp.ncpad)),
        ct_loc=rng.standard_normal((dp.nv, ng, dp.ncpad)),
        ct_rows=rng.standard_normal((ns, nvert)),
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
        for op, (out, ref, bnd) in checks.items():
            diff = (out - ref).abs()
            errs[op] = diff.max().item()
            if bnd is None:
                require(errs[op] == 0.0, f"{label} {dtype} {op}: not exact ({errs[op]:.3e})")
            else:
                off = int((diff > rtol * ref.abs() + bnd).sum())
                require(off == 0, f"{label} {dtype} {op}: {off} entries off"
                                  f" (max |diff| {errs[op]:.3e})")
        F0, loc0 = t["F"], t["loc"]
        idx, ok = yardsticks.gather_flat_index(dp, dp.g, ng, nvert)
        require(bool(ok.all()), f"{label}: gather offsets with padding slots")
        M = yardsticks.scatter_csr(dp, dp.s, ns, nvert, dtype)
        lib_g = yardsticks.gather_index_select(F0, idx).reshape(dp.nv, ng, dp.ncpad)
        lib_s = yardsticks.csr_mm(M, loc0).reshape(ns, nvert)
        lib_err = {"gather": (lib_g - checks["gather"][1]).abs().max().item(),
                   "scatter": (lib_s - checks["scatter"][1]).abs().max().item()}
        require(lib_err["gather"] == 0.0, f"{label} {dtype}: index_select not exact")
        off = int(((lib_s - checks["scatter"][1]).abs()
                   > rtol * checks["scatter"][1].abs() + checks["scatter"][2]).sum())
        require(off == 0, f"{label} {dtype}: sparse.mm scatter off ({off} entries)")
        es = F0.element_size()
        nnz = int(dp.s.ptr[nvert])
        times = {
            "gather": measure(torch, lambda: banded.banded_gather(dp, F0),
                              lambda: banded.banded_gather_reference(dp, F0, dp.g),
                              lambda: yardsticks.gather_index_select(F0, idx)),
            "scatter": measure(torch, lambda: banded.banded_scatter(dp, loc0, nvert),
                               lambda: banded.banded_scatter_reference(dp, loc0, nvert, dp.s),
                               lambda: yardsticks.csr_mm(M, loc0)),
        }
        nbytes = {
            # locals out, F in, offsets and window starts
            "gather": (dp.nv * ng * dp.ncpad + ng * nvert) * es
                      + (dp.ngroups * dp.nv * dp.gc + dp.ngroups) * 4,
            # locals in, rows out, CSR pointers and entries
            "scatter": (dp.nv * ns * dp.ncpad + ns * nvert) * es + (nvert + 1 + nnz) * 4,
        }
        tag = str(dtype).replace("torch.", "")
        for op in ("gather", "scatter"):
            r = times[op]
            r.update(max_abs_err=errs[op], bytes=nbytes[op], lib_err=lib_err[op],
                     lib_call=yardsticks.LIBRARY_CALL[op])
            r["bound_ms"], r["bound_by"] = bound_of(nbytes[op], 0, tag)
            log(f"[{tag_line}] {KERNELS[op][0]} {label} {tag}: {fmt_times(r)};"
                f" max_abs_err {errs[op]:.3e} (vjp {errs[op + '_vjp']:.3e}),"
                f" library max_abs_err {lib_err[op]:.3e}")
            results[(label, tag, op)] = r


def bench_values(ymax):
    """The properties of bench.py:111-129 (and tests/test_golden.py:103-120;
    BernoulliSmoothMinSep's widths, bench.py:808-821) on a mesh whose
    medial surface peaks at ``ymax``."""
    return dict(
        emod=5e4, rho=1.0, eta=3.0, nu=0.45, emod_membrane=0.0,
        nu_membrane=0.3, th_membrane=0.0, ycontact=ymax + 0.05,
        kcontact=1e8, rho_air=1.1225e-3, r_sep=1.0, area_lb=1e-4,
        zeta_min=1e-3, zeta_sep=1e-3, ymid=ymax + 0.01,
    )


def set_values(model, props, controls):
    """Each property and control of ``props`` / ``controls`` the model has."""
    for vec, values in ((model.prop, props), (model.control, controls)):
        for k, v in values.items():
            if k in vec:
                vec[k][:] = v


def extruded_small_values(ymax):
    """The small extruded stack's properties (tests/test_bsb.py:311-322)."""
    return dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, ycontact=ymax + 0.05, kcontact=1e8,
                rho_air=1.1225e-3, r_sep=1.0, area_lb=1e-4, ymid=ymax + 0.01)


def set_bench_props(model):
    """bench.py's properties and its psub-driven controls, each where the
    model has it (the FSAI model's psup comes from its tract)."""
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    set_values(model, bench_values(ymax), {"psub": 8000.0, "psup": 0.0})


def physics_values(ymax, large=False):
    """The physics phase's properties (``PHYSICS_PROPS`` at M5,
    ``PHYSICS_LARGE_PROPS`` at 23.7k, over bench.py's) with its glottal gap
    and contact plane, and its controls."""
    props = {**bench_values(ymax), **(PHYSICS_LARGE_PROPS if large else PHYSICS_PROPS),
             "ymid": ymax + PHYSICS_YMID_ABOVE_YMAX,
             "ycontact": ymax + PHYSICS_YCONTACT_ABOVE_YMAX}
    return props, PHYSICS_LARGE_CONTROLS if large else PHYSICS_CONTROLS


def physics_config():
    """The phase's configuration as stored with its goldens."""
    return {"props": PHYSICS_PROPS, "controls": PHYSICS_CONTROLS,
            "large_props": PHYSICS_LARGE_PROPS, "large_controls": PHYSICS_LARGE_CONTROLS,
            "separation": PHYSICS_SEPARATION, "ymid_above_ymax": PHYSICS_YMID_ABOVE_YMAX,
            "ycontact_above_ymax": PHYSICS_YCONTACT_ABOVE_YMAX,
            "m5": {k: list(v) for k, v in PHYSICS_M5.items()},
            "large": list(PHYSICS_LARGE)}


def build(torch, dev, mesh_name, dtype, solid="KelvinVoigtWEpithelium",
          fluid="BernoulliAreaRatioSep", coupling="explicit", zs=None):
    """A model of ``bench.py``'s properties on ``meshes/<mesh_name>`` (or on
    a Mesh; a 3D one with a fluid channel on each z-plane of ``zs``):
    ``(model, state0, stacked controls, prop)``."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    mesh = os.path.join(REPO, "meshes", mesh_name) if isinstance(mesh_name, str) else mesh_name
    model = load_fsi_model(
        mesh, getattr(slr, solid), getattr(flr, fluid), coupling=coupling, zs=zs, device=dev,
        dtype=dtype,
    )
    set_bench_props(model)
    state0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    controls = {k: v[None] for k, v in model.control.items()}
    return model, state0, controls, model.prop


def predictors(model):
    """The solid's Newmark predictors since its last reset: taken from K5's
    output or formed by four eager kernels (``SolidModel._predictor``)."""
    counts = dict(model.solid.predictor_counts)
    model.solid.predictor_counts.update(carried=0, formed=0)
    return counts


class RunReader:
    """A run of ``forward.integrate_pure`` read as ``postprocess.TimeSeries``
    reads a statefile (``size``, ``get_state``, ``get_control``,
    ``get_prop``), held in memory: row 0 is the initial state, row n the
    trajectory's row n - 1, as tensors where the trajectory lies (the
    card's machine has no h5py for a ``StateFile``)."""

    def __init__(self, ini_state, traj, control, prop):
        import torch

        like = next(iter(traj.values()))
        self._ini = {k: torch.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device)
                     for k, v in ini_state.items()}
        self._traj, self._control, self._prop = traj, control, prop
        self.size = 1 + like.shape[0]

    def get_state(self, n):
        return dict(self._ini) if n == 0 else {k: v[n - 1] for k, v in self._traj.items()}

    def get_control(self, n):
        return self._control

    def get_prop(self):
        return self._prop


def require_launched(launches, names, what):
    idle = [k for k in names if launches[k] == 0]
    require(not idle, f"{what}: kernels {idle} not launched ({launches})")


def phase_golden(torch, dev):
    from vf_fem_tpu_torch import forward

    data = np.load(os.path.join(REPO, "tests", "data", "golden_m5cad_explicit.npz"))
    model, state0, cs, prop = build(torch, dev, "M5_CB_GA3.msh", torch.float64)
    require(model.solid.use_banded({}), "golden: 'auto' did not pick the banded path")
    reset_launches()
    fin, traj, infos = forward.integrate_pure(model, state0, cs, prop, data["times"])
    torch.cuda.synchronize()
    launches = read_launches()
    require_launched(launches, ("gather", "scatter", "newmark"), "golden")
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
        reset_launches()
        model.solid.predictor_counts.update(carried=0, formed=0)
        start.record()
        fin, traj, infos = run()
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        ms = start.elapsed_time(end)
        require_launched(launches, ("gather", "scatter", "newmark"), f"headline {tag}")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"headline {tag}: non-finite {k}")
        require(tuple(traj["u"].shape) == (N_STEPS, model.solid.ndof), "headline: bad shape")
        steps_s = N_STEPS / (ms / 1e3)
        log(f"[headline] M5_3layers {tag} ({model.solid.ndof} dofs): {steps_s:.2f} steps/s"
            f" ({ms:.3f} ms / {N_STEPS} steps, CUDA events), launches {launches},"
            f" mean Newton rel_err {float(infos.rel_err.mean()):.3e} on {card}")
        out[tag] = dict(u=fin["u"].double().cpu().numpy(), steps_s=steps_s,
                        launches=launches)
        log(f"[headline] {tag}: Newmark predictors {predictors(model)}")
        if dtype != torch.float64:
            continue
        prof = profile_run(torch, run, N_STEPS, "newmark_kernel")
        require(prof["k_launches"] > 0, "headline profile: no K5 kernel in the trace")
        require_traced(prof, ("gather", "scatter", "newmark"), "headline")
        log(f"[headline] profile f64, {N_STEPS} steps: {prof['per_step']:.1f} device kernels"
            f" per step (eager, earlier: {EARLIER_PER_STEP['M5 headline']}), device busy"
            f" {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms profiled wall, idle share"
            f" {prof['idle']:.3f}; K5 {prof['k_ms']:.3f} ms in {prof['k_launches']} launches,"
            f" on {card}")
    u64, u32 = out["float64"]["u"], out["float32"]["u"]
    rel = float(np.abs(u32 - u64).max() / np.abs(u64).max())
    gate = 10 * JAX_CPU_F32_VS_F64
    log(f"[headline] f32 vs f64 final u: max rel diff {rel:.3e}"
        f" (gate {gate:.3e} = 10 x JAX CPU {JAX_CPU_F32_VS_F64:.3e})")
    require(rel <= gate, "headline: f32 run outside its gate")
    return out


def check_op(torch, what, kernel, plain, order_bound, rtol, work, lib=None):
    """Run ``kernel`` and ``plain`` (each returns a tuple of tensors), hold
    every output to ``rtol`` per entry plus ``order_bound`` (a matching
    tuple of summation-order bounds, or None), and the library call
    ``lib`` (a tuple too) the same way; then time all of them (``measure``).
    ``work`` is (bytes, operations, accumulation dtype) for the bound."""
    outs, refs = kernel(), plain()
    torch.cuda.synchronize()
    bounds = order_bound() if order_bound else (0.0,) * len(refs)

    def held(outs, who):
        err = 0.0
        for out, ref, b in zip(outs, refs, bounds):
            diff = (out - ref).abs()
            err = max(err, diff.max().item())
            off = int((diff > rtol * ref.abs() + b).sum())
            require(off == 0, f"{what} ({who}): {off} entries off (max |diff| {err:.3e})")
        return err

    err = held(outs, "kernel")
    lib_err = held(lib(), "library call") if lib else None
    r = measure(torch, kernel, plain, lib)
    r.update(max_abs_err=err, lib_err=lib_err, bytes=work[0])
    r["bound_ms"], r["bound_by"] = bound_of(*work)
    return r


def rest_operator(torch, model, p1):
    """The solid's element-by-element Jacobian at rest under a uniform
    surface pressure ``p1``."""
    from vf_fem_tpu_torch.convert import to_tensors

    solid = model.solid
    dev, dtype = solid.device, solid.dtype
    state0 = {k: torch.zeros(solid.ndof, dtype=dtype, device=dev) for k in "uva"}
    control = {"p1": torch.full((solid.nvert,), p1, dtype=dtype, device=dev)}
    prop = to_tensors({k: model.prop[k] for k in model._solid_prop_keys}, dev, dtype)
    return solid.jac_u_ebe(state0["u"], state0, control, prop, 1e-4)


def phase_ops(torch, dev, large):
    """K3, K4 and K5 against their plain versions on the 23.7k model's
    Jacobian (K3 on its cells and its facets, K4 on its block-banded
    array) and at M5 size (K3 on random element blocks over the
    M5_3layers cells, K5 on 960-entry vectors)."""
    from vf_fem_tpu_torch import ops, yardsticks
    from vf_fem_tpu_torch.fem import assembly
    from vf_fem_tpu_torch.mesh import load_gmsh
    from vf_fem_tpu_torch.ops import kernels
    from vf_fem_tpu_torch.solvers import bsb

    model = large
    op = rest_operator(torch, model, 500.0)
    plan, fill = model.solid.bsb_plan()
    blocks64 = bsb.bsb_fill(plan, fill, [op.J_cells, op.J_facets])
    pattern = fill.pattern
    host_pattern = bsb.matvec_pattern(plan)
    max_row = int(np.diff(host_pattern.ptr).max())
    ndof = model.solid.ndof
    m5 = load_gmsh(os.path.join(REPO, "meshes", "M5_3layers.msh"))
    m5_dofs = torch.as_tensor(assembly.cell_dof_array(m5.cells, 2), device=dev)
    rng = np.random.default_rng(0)
    host = dict(
        x=rng.standard_normal(ndof),
        m5_J=rng.standard_normal((m5.num_cells, 6, 6)),
        m5_x=rng.standard_normal(2 * m5.num_vertices),
        nm=rng.standard_normal((4, ndof)),
        m5_nm=rng.standard_normal((4, 2 * m5.num_vertices)),
    )
    log(f"[ops] 23.7k: J_cells {tuple(op.J_cells.shape)}, J_facets"
        f" {tuple(op.J_facets.shape)}, blocks {tuple(blocks64.shape)}"
        f" (nblk {plan.nblk}, nb {plan.nb}, h {plan.h}); M5: {m5.num_cells} cells")
    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        rtol = 1e-13 if dtype == torch.float64 else 1e-6
        t = {k: torch.tensor(v, dtype=dtype, device=dev) for k, v in host.items()}
        Jc, Jf, blocks = (a.to(dtype) for a in (op.J_cells, op.J_facets, blocks64))
        cases = {
            ("ebe_matvec", "23.7k cells"): (Jc, t["x"], op.cell_dofs),
            ("ebe_matvec", "23.7k facets"): (Jf, t["x"], op.facet_dofs),
            ("ebe_matvec", "M5 cells"): (t["m5_J"], t["m5_x"], m5_dofs),
        }
        es = dtype.itemsize
        for (kname, label), (J, x, d) in cases.items():
            ne, nld = J.shape[0], J.shape[-1]
            # K3 and its transpose K3T: J, x and the int64 dof map in, y out
            for name, kern, plain in (
                    (kname, ops.ebe_matvec, ops.ebe_matvec_reference),
                    (kname + "_t", ops.ebe_matvec_t, ops.ebe_matvec_t_reference)):
                results[(name, label, tag)] = check_op(
                    torch, f"ops {name} {label} {tag}",
                    lambda: (kern(J, x, d),), lambda: (plain(J, x, d),),
                    lambda: (ops.dot_order_bound(plain(J.abs(), x.abs(), d), nld),),
                    rtol,
                    ((J.numel() + x.numel() + ne * nld) * es + d.numel() * 8,
                     2 * J.numel(), tag))
        x = t["x"]
        csr = yardsticks.bsb_csr(plan, blocks, pattern)
        work = bsb_work(pattern, ndof, es)
        results[("bsb_matvec", "23.7k", tag)] = r = check_op(
            torch, f"ops bsb_matvec {tag}",
            lambda: (ops.bsb_matvec(plan, blocks, x, pattern),),
            lambda: (ops.bsb_matvec_reference(plan, blocks, x),),
            lambda: (ops.dot_order_bound(
                ops.bsb_matvec_reference(plan, blocks.abs(), x.abs()),
                plan.nb * plan.b),),
            rtol, (*work, tag),
            lib=lambda: (yardsticks.csr_mm(csr, x).reshape(-1),))
        emul = emulate_bsb(plan, host_pattern, blocks.cpu().numpy(), x.cpu().numpy(),
                           kernels.BSB_LANES)
        y = ops.bsb_matvec(plan, blocks, x, pattern).cpu().numpy()
        require(np.array_equal(y, emul), f"ops bsb_matvec {tag}: not bit-equal to"
                f" the CPU emulation ({int((y != emul).sum())} entries differ)")
        band_ms, _ = bound_of(bsb_band_bytes(plan, es), 2 * blocks.numel(), tag)
        nonzero = int(torch.count_nonzero(blocks))
        log(f"[ops] bsb_matvec {tag}: the band holds {blocks.numel()} entries, the"
            f" pattern {work[1] // 2} ({nonzero} of them nonzero), 1-{max_row} a row;"
            f" bound from the pattern's bytes {work[0] / 1e6:.3f} MB, {r['bound_ms']:.6f} ms;"
            f" the Pallas contract's bytes (the dense band) {bsb_band_bytes(plan, es) / 1e6:.3f}"
            f" MB, {band_ms:.6f} ms; bit-equal to the CPU emulation")
        results[("bsb_matvec_t", "23.7k", tag)] = bsb_t_op(torch, plan, fill, blocks, x, tag)
        for label, key in (("23.7k", "nm"), ("M5", "m5_nm")):
            # four vectors, each its own allocation as on the main path
            vecs = [torch.tensor(v, dtype=dtype, device=dev) for v in host[key]]
            results[("newmark", label, tag)] = newmark_op(torch, label, tag, vecs)
            # K5T: two cotangents and K5's four inputs
            vecs_t = [torch.tensor(v, dtype=dtype, device=dev)
                      for v in np.concatenate([host[key][:2] * 1e-3, host[key]])]
            results[("newmark_t", label, tag)] = newmark_t_op(torch, label, tag, vecs_t)
        # phase 19's batches; K5T at 64 and 256 too, the shapes a gradient
        # sweep of the leg or of BASELINE config 5 would give it (no run of
        # this script launches it there, and the kernels line has no row)
        for batch in (SWEEP_GRAD[0], SWEEP_LEG[0], SWEEP_BASELINE[0]):
            # a sweep's batch of M5 vectors (phase 19), (B, 960) each
            host_b = np.random.default_rng(batch).standard_normal((6, batch, 2 * m5.num_vertices))
            vecs = [torch.tensor(v, dtype=dtype, device=dev) for v in host_b[2:]]
            label = f"M5 x {batch}"
            results[("newmark", label, tag)] = newmark_batch_op(torch, label, tag, vecs)
            host_b[:2] *= 1e-3
            vecs_t = [torch.tensor(v, dtype=dtype, device=dev) for v in host_b]
            results[("newmark_t", label, tag)] = newmark_t_batch_op(torch, label, tag, vecs_t)
        newmark_edges(torch, dev, dtype)
        for (kname, label, tg), r in results.items():
            if tg != tag:
                continue
            r["lib_call"] = yardsticks.LIBRARY_CALL[kname]
            log(f"[ops] {kname} {label} {tag}: {fmt_times(r)}; max_abs_err"
                f" {r['max_abs_err']:.3e}"
                + ("" if r["lib_err"] is None else f", library max_abs_err {r['lib_err']:.3e}"))
    cases = sweep_cases(torch, plan, blocks64)
    k6 = phase_ops_btd(torch, cases)
    results.update(k6)
    results.update(phase_ops_btd_t(torch, cases, k6))
    return results


def bsb_t_op(torch, plan, fill, blocks, x, tag):
    """K4T (``ops.bsb_matvec_t`` on the transposed pattern) against its
    plain version (the JAX package's algorithm over the whole band) within
    rtol 1e-13 / 1e-6 plus the summation-order bound, against the library
    call (``torch.sparse.mm`` on the CSR of A^T), bit for bit against its
    CPU emulation (``tests/bsb_emulation.py``), and the same bits in three
    launches; then its timing row."""
    from vf_fem_tpu_torch import ops, yardsticks
    from vf_fem_tpu_torch.ops import kernels

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from bsb_emulation import emulate_bsb_matvec_t

    es = x.element_size()
    csr_t = yardsticks.bsb_csr_t(plan, blocks, fill.pattern_t)
    r = check_op(
        torch, f"ops bsb_matvec_t {tag}",
        lambda: (ops.bsb_matvec_t(plan, blocks, x, fill.pattern_t),),
        lambda: (ops.bsb_matvec_t_reference(plan, blocks, x),),
        lambda: (ops.dot_order_bound(
            ops.bsb_matvec_t_reference(plan, blocks.abs(), x.abs()), plan.nb * plan.b),),
        1e-13 if x.dtype == torch.float64 else 1e-6,
        (*bsb_work(fill.pattern_t, plan.ndof, es), tag),
        lib=lambda: (yardsticks.csr_mm(csr_t, x).reshape(-1),))
    ys = [ops.bsb_matvec_t(plan, blocks, x, fill.pattern_t) for _ in range(3)]
    torch.cuda.synchronize()
    require(all(torch.equal(y, ys[0]) for y in ys[1:]),
            f"ops bsb_matvec_t {tag}: not the same bits in 3 launches")
    host_t = type(fill.pattern_t)(*(a.cpu().numpy() for a in fill.pattern_t))
    emul = emulate_bsb_matvec_t(plan, host_t, blocks.cpu().numpy(), x.cpu().numpy(),
                                kernels.BSB_LANES)
    y = ys[0].cpu().numpy()
    require(np.array_equal(y, emul), f"ops bsb_matvec_t {tag}: not bit-equal to the CPU"
            f" emulation ({int((y != emul).sum())} entries differ)")
    log(f"[ops] bsb_matvec_t {tag}: the same bits in 3 launches, bit-equal to the CPU"
        f" emulation; {-(-plan.ndof // kernels.BSB_T_COLS)} CTAs of {kernels.BSB_T_COLS}"
        f" columns; bound from the transposed pattern's bytes {r['bytes'] / 1e6:.3f} MB")
    return r


def newmark_work(n, itemsize):
    """K5's (bytes, operations): u1, u0, v0, a0 in, v1, a1 and u_next out,
    and its row of eight coefficients; 15 operations an entry (6 for v1, 5
    more for a1, 4 for u_next)."""
    return (7 * n + 8) * itemsize, 15 * n


def newmark_row(like, dt=DT, dt_next=None):
    """A row of K5's coefficients (``equations.newmark``) in the dtype and
    on the device of ``like``."""
    from vf_fem_tpu_torch import ops
    from vf_fem_tpu_torch.equations import newmark

    return ops.newmark_row(newmark.coefficients(dt, dt_next), like.dtype, like.device)


def newmark_equal(torch, what, args, dt=DT, dt_next=None):
    """K5 on ``args`` (u1, u0, v0, a0) with its coefficients read from a row
    in device memory (as the time loop calls it) and through the float API,
    against its plain version: all three outputs bit for bit; returns the
    kernel's outputs."""
    from vf_fem_tpu_torch import ops

    outs = ops.newmark_update_coefs(*args, newmark_row(args[0], dt, dt_next))
    floats = ops.newmark_update(*args, dt, dt_next=dt_next)
    refs = ops.newmark_update_reference(*args, dt, dt_next=dt_next)
    torch.cuda.synchronize()
    require(len(outs) == 3, f"{what}: K5 returned {len(outs)} outputs")
    for name, out, flo, ref in zip(("v1", "a1", "u_next"), outs, floats, refs):
        require(torch.equal(out, ref) and torch.equal(flo, ref),
                f"{what}: K5's {name} not bit-equal to the plain version (max |diff|"
                f" {(out - ref).abs().max().item():.3e})")
    return outs


def newmark_op(torch, label, tag, vecs):
    """K5 at one size: bit-equal to its plain version, eagerly and replayed
    in a CUDA graph (its programmatic dependent launch captured) that reads
    its coefficient row after a step counter, as the captured time step
    does; then its timing row (``measure``) for the time loop's call, a
    row of a coefficient table."""
    from vf_fem_tpu_torch import ops, yardsticks
    from vf_fem_tpu_torch.equations import newmark

    what = f"ops newmark {label} {tag}"
    newmark_equal(torch, what, vecs)
    dev = vecs[0].device
    steps = ((DT, 0.75 * DT), (0.75 * DT, DT))
    table = ops.newmark_row([newmark.coefficients(*st) for st in steps], vecs[0].dtype, dev)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    static = [v.clone() for v in vecs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.newmark_update_coefs(*static, table.index_select(0, counter)[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.newmark_update_coefs(*static, table.index_select(0, counter)[0])
        counter.add_(1)
    for v, w in zip(static, vecs):
        v.copy_(w.flip(0))  # new inputs in place: the replay reads them
    for i, st in enumerate(steps):
        graph.replay()
        torch.cuda.synchronize()
        eager = ops.newmark_update_reference(*static, st[0], dt_next=st[1])
        require(all(torch.equal(c, e) for c, e in zip(captured, eager)),
                f"{what}: the CUDA-graph replay of row {i} differs from the plain version")
    row = table[0]
    r = measure(torch, lambda: ops.newmark_update_coefs(*vecs, row),
                lambda: ops.newmark_update_coefs_reference(*vecs, row))
    n, es = vecs[0].numel(), vecs[0].element_size()
    r.update(max_abs_err=0.0, lib_err=None, bytes=newmark_work(n, es)[0],
             lib_call=yardsticks.LIBRARY_CALL["newmark"])
    r["bound_ms"], r["bound_by"] = bound_of(*newmark_work(n, es), tag)
    return r


def newmark_t_work(n, itemsize):
    """K5T's (bytes, operations): the cotangents of v1 and a1, K5's four
    inputs and the row in, four vector cotangents and the row's out (the
    CTAs' partial sums, six a CTA in the launch's slot, stay in L2); 28
    operations an entry."""
    return (10 * n + 16) * itemsize, 28 * n


def newmark_t_equal(torch, what, vecs, row):
    """K5T on ``vecs`` (vb1, ab1, u1, u0, v0, a0) in three launches against
    its plain version: the four vector cotangents bit for bit, the row's
    cotangent the same bits in every launch, within rtol 1e-13 / 1e-6 plus
    the bound on summation order, and its entries 6 and 7 zero; returns the
    largest difference of the row's cotangent."""
    from vf_fem_tpu_torch import ops

    outs = [ops.newmark_update_t(*vecs, row) for _ in range(3)]
    refs = ops.newmark_update_t_reference(*vecs, row)
    torch.cuda.synchronize()
    for name, out, ref in zip(("ub1", "ub0", "vb0", "ab0"), outs[0], refs):
        require(torch.equal(out, ref), f"{what}: K5T's {name} not bit-equal to the plain"
                f" version (max |diff| {(out - ref).abs().max().item():.3e})")
    require(all(torch.equal(o[4], outs[0][4]) for o in outs[1:]),
            f"{what}: the row's cotangent differs between launches")
    vb1, ab1, u1, u0, v0, a0 = vecs
    bound = ops.dot_order_bound(ops.newmark_update_t_reference(
        vb1.abs(), ab1.abs(), u1.abs(), -u0.abs(), -v0.abs(), -a0.abs(), row.abs())[4].abs(),
        u1.numel())
    rtol = 1e-13 if u1.dtype == torch.float64 else 1e-6
    diff = (outs[0][4] - refs[4]).abs()
    require(bool((diff <= rtol * refs[4].abs() + bound).all()),
            f"{what}: the row's cotangent off the plain version's ({diff.max().item():.3e})")
    require(not bool(outs[0][4][6:].any()), f"{what}: the row's entries 6 and 7 not zero")
    return diff.max().item()


def newmark_t_graph(torch, what, vecs, replays=200):
    """K5T captured once in a CUDA graph (its programmatic dependent launch
    and its arrival counter captured) and replayed ``replays`` times with
    a new coefficient row written in place between replays: the row's
    cotangent has the bits of an eager launch on the same row, the vector
    cotangents those of the plain version."""
    from vf_fem_tpu_torch import ops
    from vf_fem_tpu_torch.equations import newmark

    dev, dtype = vecs[0].device, vecs[0].dtype
    rows = ops.newmark_row([newmark.coefficients(DT * (1 + 0.01 * i), 0.75 * DT)
                            for i in range(replays)], dtype, dev)
    row = rows[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.newmark_update_t(*vecs, row)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.newmark_update_t(*vecs, row)
    for i in range(replays):
        row.copy_(rows[i])
        graph.replay()
        eager = ops.newmark_update_t(*vecs, rows[i])
        refs = ops.newmark_update_t_reference(*vecs, rows[i])
        torch.cuda.synchronize()
        require(torch.equal(captured[4], eager[4]),
                f"{what}: replay {i}: the row's cotangent differs from an eager launch's")
        require(all(torch.equal(c, r) for c, r in zip(captured[:4], refs[:4])),
                f"{what}: replay {i}: a vector cotangent differs from the plain version")


def newmark_t_streams(torch, what, vecs, launches=20, replays=50):
    """Two CUDA graphs of ``launches`` K5T launches each, both captured on
    PyTorch's one capture stream, replayed ``replays`` times at once on two
    other streams, new rows written into each graph's inputs on its stream
    before each replay: every launch's row cotangent has the bits of an
    eager launch on its row (each capture has slots of its own, so the two
    graphs never share an arrival counter)."""
    from vf_fem_tpu_torch import ops
    from vf_fem_tpu_torch.equations import newmark

    dev, dtype = vecs[0].device, vecs[0].dtype
    table = ops.newmark_row([newmark.coefficients(DT * (1 + 1e-3 * i), 0.75 * DT)
                             for i in range(replays * 2 * launches)], dtype, dev)
    table = table.view(replays, 2, launches, -1)
    rows = [table[0, g].clone() for g in range(2)]
    graphs, sinks = [], []
    for g in range(2):
        graph, sink = torch.cuda.CUDAGraph(), torch.empty_like(rows[g])
        with torch.cuda.graph(graph):
            for k in range(launches):
                sink[k].copy_(ops.newmark_update_t(*vecs, rows[g][k])[4])
        graphs.append(graph)
        sinks.append(sink)
    record = torch.empty_like(table)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for r in range(replays):
        for g, st in enumerate(streams):
            with torch.cuda.stream(st):
                rows[g].copy_(table[r, g])
                graphs[g].replay()
                record[r, g].copy_(sinks[g])
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    eager = torch.stack([ops.newmark_update_t(*vecs, row)[4]
                         for row in table.view(-1, table.shape[-1])])
    torch.cuda.synchronize()
    off = int((record.view(eager.shape) != eager).any(dim=1).sum())
    require(off == 0, f"{what}: {off} of {eager.shape[0]} launches in two graphs replayed at"
            " once on two streams differ from eager launches")


def newmark_t_trace(torch, what, vecs, row, calls=10):
    """``calls`` calls of K5T under ``torch.profiler``: exactly one device
    kernel a call, and that kernel is K5T's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vf_fem_tpu_torch import ops

    ops.newmark_update_t(*vecs, row)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.newmark_update_t(*vecs, row)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    require(sum(c for _, c in kernels) == calls
            and all(TRACE_NAMES["newmark_t"] in k for k, _ in kernels),
            f"{what}: not one K5T kernel a call in the trace: {kernels}")


def newmark_t_op(torch, label, tag, vecs):
    """K5T (K5's backward) at one size against its plain version
    (``newmark_t_equal``), replayed 200 times in a CUDA graph on new rows
    (``newmark_t_graph``), in two graphs replayed at once on two streams
    (``newmark_t_streams``), one device kernel a call in the profiler's
    trace (``newmark_t_trace``); then its timing row (``measure``)."""
    from vf_fem_tpu_torch import ops, yardsticks

    what = f"ops newmark_t {label} {tag}"
    row = newmark_row(vecs[0], DT, 0.75 * DT)
    err = newmark_t_equal(torch, what, vecs, row)
    newmark_t_graph(torch, what, vecs)
    newmark_t_streams(torch, what, vecs)
    newmark_t_trace(torch, what, vecs, row)
    r = measure(torch, lambda: ops.newmark_update_t(*vecs, row),
                lambda: ops.newmark_update_t_reference(*vecs, row))
    n, es = vecs[0].numel(), vecs[0].element_size()
    r.update(max_abs_err=err, lib_err=None, bytes=newmark_t_work(n, es)[0],
             lib_call=yardsticks.LIBRARY_CALL["newmark_t"])
    r["bound_ms"], r["bound_by"] = bound_of(*newmark_t_work(n, es), tag)
    log(f"[ops] newmark_t {label} {tag} (n = {n}): vector cotangents bit-equal to the plain"
        f" version, the row's within its order bound (max |diff| {err:.3e}), the same bits"
        f" in 3 launches, in 200 graph replays on new rows and in two graphs replayed at once"
        f" on two streams as eager; one device kernel a call")
    return r


def newmark_batch_op(torch, label, tag, vecs):
    """K5 on a batch of variants ((B, n) vectors under one row, one launch
    over B n entries) bit-equal to its plain version, eagerly and replayed
    in a CUDA graph; then its timing row."""
    from vf_fem_tpu_torch import ops, yardsticks

    what = f"ops newmark {label} {tag}"
    row = newmark_row(vecs[0], DT, 0.75 * DT)
    before = ops.LAUNCHES["newmark"]
    outs = ops.newmark_update_coefs(*vecs, row)
    require(ops.LAUNCHES["newmark"] == before + 1, f"{what}: not one launch for the batch")
    refs = ops.newmark_update_coefs_reference(*vecs, row)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.newmark_update_coefs(*vecs, row)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = ops.newmark_update_coefs(*vecs, row)
    graph.replay()
    torch.cuda.synchronize()
    for name, out, cap, ref in zip(("v1", "a1", "u_next"), outs, captured, refs):
        require(torch.equal(out, ref) and torch.equal(cap, ref),
                f"{what}: K5's {name} not bit-equal to the plain version")
    r = measure(torch, lambda: ops.newmark_update_coefs(*vecs, row),
                lambda: ops.newmark_update_coefs_reference(*vecs, row))
    n, es = vecs[0].numel(), vecs[0].element_size()
    r.update(max_abs_err=0.0, lib_err=None, bytes=newmark_work(n, es)[0],
             lib_call=yardsticks.LIBRARY_CALL["newmark"])
    r["bound_ms"], r["bound_by"] = bound_of(*newmark_work(n, es), tag)
    cold_device(torch, r, lambda *v: ops.newmark_update_coefs(*v, row), vecs)
    log(f"[ops] newmark {label} {tag} ({tuple(vecs[0].shape)}): one launch, bit-equal to the"
        f" plain version eagerly and in a graph replay; device {r['device_ms']:.6f} ms with"
        f" its inputs cold in L2, {r['device_warm_ms']:.6f} ms warm")
    return r


def cold_device(torch, r, fn, vecs):
    """A batched K5 / K5T row's device time with its inputs cold in L2
    (``graph_ms_cold``; a batch of 256 moves 14-20 MB, which 200 replays
    on one set of inputs find in the 50 MB L2), the warm graph time kept
    as ``device_warm_ms``."""
    r["device_warm_ms"] = r["device_ms"]
    r["device_ms"] = graph_ms_cold(torch, fn, vecs, r["bytes"])


def newmark_t_batch_op(torch, label, tag, vecs):
    """K5T on a batch of variants (``ops.newmark_update_t_batch``, a CTA a
    variant) against its batched plain version: the vector cotangents bit
    for bit, each variant's row within rtol 1e-13 / 1e-6 plus its summation
    order bound, the same bits in three launches and in a graph replay;
    then its timing row."""
    from vf_fem_tpu_torch import ops, yardsticks

    what = f"ops newmark_t {label} {tag}"
    row = newmark_row(vecs[0], DT, 0.75 * DT)
    outs = [ops.newmark_update_t_batch(*vecs, row) for _ in range(3)]
    refs = ops.newmark_update_t_batch_reference(*vecs, row)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.newmark_update_t_batch(*vecs, row)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.newmark_update_t_batch(*vecs, row)
    graph.replay()
    torch.cuda.synchronize()
    for name, out, ref in zip(("ub1", "ub0", "vb0", "ab0"), outs[0], refs):
        require(torch.equal(out, ref), f"{what}: K5T's {name} not bit-equal to the plain version")
    require(all(torch.equal(o[4], outs[0][4]) for o in outs[1:] + [captured]),
            f"{what}: the rows' cotangents differ between launches")
    vb1, ab1, u1, u0, v0, a0 = vecs
    bound = ops.dot_order_bound(ops.newmark_update_t_batch_reference(
        vb1.abs(), ab1.abs(), u1.abs(), -u0.abs(), -v0.abs(), -a0.abs(), row.abs())[4].abs(),
        u1.shape[-1])
    rtol = 1e-13 if u1.dtype == torch.float64 else 1e-6
    diff = (outs[0][4] - refs[4]).abs()
    require(bool((diff <= rtol * refs[4].abs() + bound).all()),
            f"{what}: a row's cotangent off the plain version's ({diff.max().item():.3e})")
    require(not bool(outs[0][4][:, 6:].any()), f"{what}: the rows' entries 6 and 7 not zero")
    r = measure(torch, lambda: ops.newmark_update_t_batch(*vecs, row),
                lambda: ops.newmark_update_t_batch_reference(*vecs, row))
    n, es = vecs[0].numel(), vecs[0].element_size()
    work = ((10 * n + 8 + 8 * vecs[0].shape[0]) * es, 28 * n)
    r.update(max_abs_err=diff.max().item(), lib_err=None, bytes=work[0],
             lib_call=yardsticks.LIBRARY_CALL["newmark_t"])
    r["bound_ms"], r["bound_by"] = bound_of(*work, tag)
    cold_device(torch, r, lambda *v: ops.newmark_update_t_batch(*v, row), vecs)
    log(f"[ops] newmark_t {label} {tag} ({tuple(u1.shape)}): vector cotangents bit-equal to"
        f" the plain version, each variant's row within its order bound (max |diff|"
        f" {diff.max().item():.3e}), the same bits in 3 launches and a graph replay; device"
        f" {r['device_ms']:.6f} ms with its inputs cold in L2, {r['device_warm_ms']:.6f} ms"
        f" warm")
    return r


def newmark_edges(torch, dev, dtype):
    """K5 bit-equal to its plain version off the main path's shapes: an odd
    length, views that start off the 16-byte alignment (all four in one
    phase, and in mixed phases: the scalar path), and a predictor of
    another step than the update's; then K5T (``newmark_t_equal``) at n =
    1, 7, an odd length and the three meshes' sizes, on views off the
    alignment and in mixed phases."""
    rng = np.random.default_rng(5)
    tag = str(dtype).replace("torch.", "")
    for n in (123, 960, 23_754):
        host = rng.standard_normal((4, n + 3))
        full = [torch.tensor(h, dtype=dtype, device=dev) for h in host]
        newmark_equal(torch, f"newmark n={n} {tag}", [f[:n] for f in full])
        newmark_equal(torch, f"newmark n={n} {tag} views at +1", [f[1:n + 1] for f in full])
        newmark_equal(torch, f"newmark n={n} {tag} views at +1, +2, +3, +0",
                      [f[k:n + k] for f, k in zip(full, (1, 2, 3, 0))])
        newmark_equal(torch, f"newmark n={n} {tag} dt_next", [f[:n] for f in full],
                      dt_next=0.75 * DT)
    log(f"[ops] newmark {tag}: bit-equal to the plain version at n = 123, 960, 23754,"
        " on views at +1 entry and at mixed phases, and with another predictor step,"
        " its coefficients read from a row in device memory")
    for n in (1, 7, 123, 960, 23_754, 94_810):
        host = rng.standard_normal((6, n + 3))
        host[:2] *= 1e-3
        full = [torch.tensor(h, dtype=dtype, device=dev) for h in host]
        row = newmark_row(full[0], DT, 0.75 * DT)
        newmark_t_equal(torch, f"newmark_t n={n} {tag}", [f[:n] for f in full], row)
        newmark_t_equal(torch, f"newmark_t n={n} {tag} views at +1",
                        [f[1:n + 1] for f in full], row)
        newmark_t_equal(torch, f"newmark_t n={n} {tag} views at +1, +2, +3, +0, +1, +2",
                        [f[k:n + k] for f, k in zip(full, (1, 2, 3, 0, 1, 2))], row)
    log(f"[ops] newmark_t {tag}: vector cotangents bit-equal to the plain version and the"
        " row's within its order bound, the same bits in 3 launches, at n = 1, 7, 123, 960,"
        " 23754, 94810, on views at +1 entry and at mixed phases")


def sweep_double_rounding(torch, dev):
    """K6's f64 -> bf16 cast of the carried vector against torch's on a
    value where rounding through f32 and rounding directly differ:
    1 + 2^-8 + 2^-40 rounds to 1 through f32 (a tie, to even) and to
    1 + 2^-7 directly.  A_1 picks entry 0 of y_0 = g_0, so y_1[0] =
    g_1[0] - bf16(g_0[0])."""
    from vf_fem_tpu_torch import ops

    A = torch.zeros((2, 128, 128), dtype=torch.bfloat16, device=dev)
    A[1, 0, 0] = 1.0
    g = torch.zeros((2, 128), dtype=torch.float64, device=dev)
    g[0, 0] = 1 + 2.0 ** -8 + 2.0 ** -40
    y, ref = ops.btd_sweep(A, g), ops.btd_sweep_reference(A, g)
    torch.cuda.synchronize()
    require(torch.equal(y, ref), f"btd_sweep: f64 -> bf16 cast differs from torch's"
                                 f" ({y[1, 0].item()!r} vs {ref[1, 0].item()!r})")
    return -ref[1, 0].item()


def sweep_cases(torch, plan, blocks64):
    """The inputs of K6 and K6T on a model's own factors at rest under
    500 Ba (the 23.7k model's in phase 3, the 45.8k 3D fold's, Bt = 1280,
    in phase 17), for every (factor, vector) dtype pair of the btd path: a
    list of ``(ftag, vdt, factors, rb)``, ``rb`` = r / d for a seeded r,
    padded to the row blocks."""
    from vf_fem_tpu_torch.solvers import btd

    dev = blocks64.device
    factors = {
        "bfloat16": btd.btd_factor(plan, blocks64, store_dtype="bfloat16"),
        "float64": btd.btd_factor(plan, blocks64),
        "float32": btd.btd_factor(plan, blocks64.float()),
    }
    n_sup, bt, _ = factors["float64"].V.shape
    r = np.random.default_rng(1).standard_normal(plan.ndof)
    cases = []
    for ftag, vdt in (("bfloat16", torch.float64), ("bfloat16", torch.float32),
                      ("float64", torch.float64), ("float32", torch.float32)):
        fac = factors[ftag]
        d = fac.d.to(vdt)[: plan.ndof]
        rb = torch.nn.functional.pad(torch.tensor(r, dtype=vdt, device=dev) / d,
                                     (0, n_sup * bt - plan.ndof)).reshape(n_sup, bt)
        cases.append((ftag, vdt, fac, rb))
    return cases


def sweep_tolerances(torch, ftag, vdt):
    """A row's rtol (beside its order bound) and the accumulation dtype
    whose ``SWEEP_FULL_GATES`` entry holds the whole sweep."""
    return (1e-13 if vdt == torch.float64 else 1e-6), ("float64" if ftag == "float64"
                                                      else "float32")


def phase_ops_btd(torch, cases, line="ops"):
    """K6 against its plain version on ``sweep_cases``: the forward sweep
    over V from g = Sinv r and the backward sweep over W from the plain
    forward sweep's output.  Each row is held to the plain version's row
    computed from the kernel's own previous row (rtol 1e-13 / 1e-6 plus the
    dot-product order bound, exact), and the whole sweep to the plain sweep
    (``SWEEP_FULL_GATES``); K6's launch plans at every width and dtype pair
    are held to the built kernel's, and its f64 -> bf16 cast to torch's."""
    from vf_fem_tpu_torch import ops, yardsticks
    from vf_fem_tpu_torch.ops import kernels

    dev = cases[0][3].device
    n_sup, bt = cases[0][3].shape
    cast = sweep_double_rounding(torch, dev)
    log(f"[{line}] btd_sweep: f64 -> bf16 cast of 1 + 2^-8 + 2^-40 as torch's: {cast!r}")
    for fdt, vdt in kernels._SWEEP_TYPES:
        for w in kernels.SWEEP_WIDTHS:
            plan_py, plan_cu = ops.sweep_plan(w, fdt, vdt), kernels.built_sweep_plan(w, fdt)
            require(plan_py == plan_cu, f"btd_sweep plan {w} {fdt}/{vdt}: ops.sweep_plan"
                                        f" {plan_py} is not the kernel's {plan_cu}")
    results = {}
    for ftag, vdt, fac, rb in cases:
        vtag = str(vdt).replace("torch.", "")
        g = ops.factor_matvec(fac.Sinv, rb)
        y = ops.btd_sweep_reference(fac.V, g)
        rtol, acc = sweep_tolerances(torch, ftag, vdt)
        for label, A, inp, rev in (("forward", fac.V, g, False), ("backward", fac.W, y, True)):
            what = f"ops btd_sweep {label} {ftag}/{vtag}"
            out = ops.btd_sweep(A, inp, reverse=rev)
            torch.cuda.synchronize()
            row_ref, bound = ops.btd_sweep_rows_reference(A, inp, out, rev)
            diff = (out - row_ref).abs()
            off = int((diff > rtol * row_ref.abs() + bound).sum())
            require(off == 0, f"{what}: {off} entries off their rows"
                              f" (max |diff| {diff.max().item():.3e})")
            full = ops.btd_sweep_reference(A, inp, rev)
            err = (out - full).abs().max().item()
            full_rel = err / full.abs().max().item()
            require(full_rel <= SWEEP_FULL_GATES[acc],
                    f"{what}: whole sweep off the plain one ({full_rel:.3e})")
            res = measure(torch, lambda: ops.btd_sweep(A, inp, reverse=rev),
                          lambda: ops.btd_sweep_reference(A, inp, rev))
            # factors and g in, the sweep out; 2 Bt^2 operations per block
            nbytes = A.numel() * A.element_size() + 2 * inp.numel() * inp.element_size()
            res.update(max_abs_err=err, bytes=nbytes, lib_ms=None, lib_runs=None,
                       lib_call=yardsticks.LIBRARY_CALL["btd_sweep"])
            res["bound_ms"], res["bound_by"] = bound_of(nbytes, 2 * A.numel(), acc)
            sp = ops.sweep_plan(bt, A.dtype, vdt)
            log(f"[{line}] btd_sweep {label} {ftag} factors / {vtag} vector ({n_sup} x {bt} x {bt}):"
                f" {fmt_times(res)}; row max |diff| {diff.max().item():.3e}, whole-sweep"
                f" max_abs_err {err:.3e} (rel {full_rel:.3e}, gate {SWEEP_FULL_GATES[acc]:.0e});"
                f" cluster of {sp.cluster} CTAs ({sp.warps} consumer warps, ring of"
                f" {sp.ring} slots of {sp.stage_rows} rows, {sp.smem_bytes} B shared):"
                f" {res['device_ms'] / n_sup * 1e3:.3f} us per row block")
            results[("btd_sweep", f"{label} {ftag}/{vtag}", vtag)] = res
    return results


def phase_ops_btd_t(torch, cases, k6):
    """K6T, the transposed sweeps of ``btd_solve_t``, against its plain
    version on ``sweep_cases``: forward on W from r / d, backward on V from
    the plain forward sweep's output, held as K6 is (``phase_ops_btd``,
    whose results ``k6`` give K6's time a row block beside K6T's) and to
    the same bits in three launches.  K6T's launch plans at every width and
    dtype pair are held to the built kernel's, and K6's exchange is timed
    alone by ``sweep_exchange``, whose time a row block K6T's line shows."""
    from vf_fem_tpu_torch import ops, yardsticks
    from vf_fem_tpu_torch.ops import kernels

    dev = cases[0][3].device
    n_sup, bt = cases[0][3].shape
    for fdt, vdt in kernels._SWEEP_TYPES:
        for w in kernels.SWEEP_T_WIDTHS:
            plan_py = ops.sweep_t_plan(w, fdt, vdt)
            plan_cu = kernels.built_sweep_t_plan(w, fdt)
            require(plan_py == plan_cu, f"btd_sweep_t plan {w} {fdt}/{vdt}:"
                                        f" ops.sweep_t_plan {plan_py} is not the"
                                        f" kernel's {plan_cu}")
    exchange_us = sweep_exchange(torch, dev, bt)
    results = {}
    for ftag, vdt, fac, rb in cases:
        vtag = str(vdt).replace("torch.", "")
        z = ops.btd_sweep_t_reference(fac.W, rb)
        rtol, acc = sweep_tolerances(torch, ftag, vdt)
        for label, A, inp, rev in (("forward", fac.W, rb, False), ("backward", fac.V, z, True)):
            what = f"ops btd_sweep_t {label} {ftag}/{vtag}"
            out = ops.btd_sweep_t(A, inp, reverse=rev)
            outs = [out] + [ops.btd_sweep_t(A, inp, reverse=rev) for _ in range(2)]
            torch.cuda.synchronize()
            require(all(torch.equal(o, out) for o in outs[1:]),
                    f"{what}: not the same bits in three launches")
            row_ref, bound = ops.btd_sweep_t_rows_reference(A, inp, out, rev)
            diff = (out - row_ref).abs()
            off = int((diff > rtol * row_ref.abs() + bound).sum())
            require(off == 0, f"{what}: {off} entries off their rows"
                              f" (max |diff| {diff.max().item():.3e})")
            full = ops.btd_sweep_t_reference(A, inp, rev)
            err = (out - full).abs().max().item()
            full_rel = err / full.abs().max().item()
            require(full_rel <= SWEEP_FULL_GATES[acc],
                    f"{what}: whole sweep off the plain one ({full_rel:.3e})")
            res = measure(torch, lambda: ops.btd_sweep_t(A, inp, reverse=rev),
                          lambda: ops.btd_sweep_t_reference(A, inp, rev))
            # the n - 1 blocks the sweep reads, g in, the sweep out; 2 Bt^2
            # operations a block
            blk = A[0].numel()
            nbytes = ((n_sup - 1) * blk * A.element_size()
                      + 2 * inp.numel() * inp.element_size())
            res.update(max_abs_err=err, bytes=nbytes, lib_ms=None, lib_runs=None,
                       lib_call=yardsticks.LIBRARY_CALL["btd_sweep_t"])
            res["bound_ms"], res["bound_by"] = bound_of(nbytes, 2 * (n_sup - 1) * blk, acc)
            tp = ops.sweep_t_plan(bt, A.dtype, vdt)
            k6_ms = k6[("btd_sweep", f"{label} {ftag}/{vtag}", vtag)]["device_ms"]
            log(f"[ops] btd_sweep_t {label} {ftag} factors / {vtag} vector ({n_sup} x {bt} x"
                f" {bt}): {fmt_times(res)}; row max |diff| {diff.max().item():.3e}, whole-sweep"
                f" max_abs_err {err:.3e} (rel {full_rel:.3e}, gate {SWEEP_FULL_GATES[acc]:.0e});"
                f" same bits in 3 launches; cluster of {tp.cluster} CTAs ({tp.warps} consumer"
                f" warps, ring of {tp.ring} slots of {tp.stage_rows} box rows, {tp.smem_bytes} B"
                f" shared): {res['device_ms'] / n_sup * 1e3:.3f} us per row block (K6"
                f" {k6_ms / n_sup * 1e3:.3f}"
                + ("" if A.dtype not in exchange_us else
                   f", the exchange alone {exchange_us[A.dtype]:.3f}: a chain floor of"
                   f" {n_sup * exchange_us[A.dtype] / 1e3:.6f} ms") + ")")
            results[("btd_sweep_t", f"{label} {ftag}/{vtag}", vtag)] = res
    return results


def exchange_probe(torch, n, bt, factor_dtype, barrier, dev):
    """One launch of ``csrc/btd_exchange_probe.cu``: ``n`` row blocks of
    pushes of K6's carried vector (``bt`` entries of ``factor_dtype``, bf16
    or f64) across K6's cluster for that type; returns each CTA's copy of
    the last vector pushed, (cluster, bt)."""
    from vf_fem_tpu_torch import cuda_build, ops

    suffix = {torch.bfloat16: "bf16", torch.float64: "f64"}[factor_dtype]
    fn = f"vf_btd_exchange_probe_{suffix}"
    lib = cuda_build.load("btd_exchange_probe.cu", PROBE_SIGNATURES)
    cluster = ops.sweep_plan(bt, factor_dtype, torch.float64).cluster
    sink = torch.empty((cluster, bt), dtype=factor_dtype, device=dev)
    err = getattr(lib, fn)(sink.data_ptr(), n, bt, int(barrier), cuda_build.raw_stream(sink))
    require(err == 0, f"{fn} launch failed: cudaError_t {err}")
    return sink


def sweep_exchange(torch, dev, bt):
    """K6's exchange alone (``exchange_probe``): the device time of one row
    block's push of the carried vector across K6's cluster and the wait for
    it, by st.async on mbarriers (as K6) and by remote stores with
    barrier.cluster, for bf16 and f64 vectors of ``bt`` entries; per row
    block from the difference of graph-replayed launches of 93 and 1023 row
    blocks (launch cost out).  Each CTA starts with only its own entries,
    entry k holding the bits k + 1, so every CTA's copy of the vector after
    3 row blocks holds them all only if every push landed where it should.
    Returns the st.async exchange's us per row block by factor dtype."""
    us = {}
    for ftype, bits in ((torch.bfloat16, torch.int16), (torch.float64, torch.int64)):
        for barrier in (False, True):
            t = {n: graph_ms(torch, lambda: exchange_probe(torch, n, bt, ftype, barrier, dev),
                             reps=50) for n in (93, 1023)}
            sink = exchange_probe(torch, 3, bt, ftype, barrier, dev).view(bits)
            want = torch.arange(1, bt + 1, dtype=bits, device=dev).expand_as(sink)
            how = "barrier.cluster" if barrier else "st.async"
            require(torch.equal(sink, want), f"exchange probe {ftype} {how}: wrong vector landed")
            log(f"[ops] btd_sweep exchange {str(ftype).replace('torch.', '')} x {bt},"
                f" cluster {sink.shape[0]}, {how}: {(t[1023] - t[93]) / 930 * 1e3:.4f} us per"
                f" row block ({t[93]:.6f} ms for 93 blocks, {t[1023]:.6f} ms for 1023)")
            if not barrier:
                us[ftype] = (t[1023] - t[93]) / 930 * 1e3
    return us


def run_timed(torch, model, run):
    """One run after resetting the launch and Krylov counts, timed by CUDA
    events; returns (outputs, ms, launches, krylov counts)."""
    solid = model.solid
    solid.krylov_counts.update(solves=0, iterations=0)
    solid.predictor_counts.update(carried=0, formed=0)
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), read_launches(), dict(solid.krylov_counts)


def rel_max(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_krylov(torch, card, models):
    """Tight runs against the JAX package's golden, then the production
    settings (no warm-up run: the tight runs warmed each solver's path)
    with their gates."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_large_bsb_explicit.npz"))
    times = gold["times"]
    n_steps = len(times) - 1
    every = int(gold["steps"][0])
    traj_gate = 10 * float(gold["prod_traj_err"])
    f32_gate = 10 * float(gold["prod_f32_vs_f64"])
    used = {"bsb": ("gather", "scatter", "bsb_matvec", "newmark"),
            "cg": ("gather", "scatter", "ebe_matvec", "newmark")}
    unused = {"bsb": "ebe_matvec", "cg": "bsb_matvec"}

    def drive(tag, params):
        model, state0, cs, prop = models[tag]
        return run_timed(torch, model, lambda: forward.integrate_pure(
            model, state0, cs, prop, times, params))

    def summary(what, infos, ms, launches, kc):
        mean_krylov = kc["iterations"] / max(kc["solves"], 1)
        return (f"{what}: {n_steps / (ms / 1e3):.2f} steps/s ({ms:.3f} ms / {n_steps}"
                f" steps, CUDA events), Krylov {kc['iterations']} iterations in"
                f" {kc['solves']} solves ({mean_krylov:.2f} per solve; one host"
                f" sync each), Newton mean {float(infos.num_iter.double().mean()):.2f}"
                f" iterations {infos.num_iter.tolist()}, max abs_err"
                f" {float(infos.abs_err.max()):.3e}, launches {launches}, on {card}")

    tight = {}
    for ls in ("bsb", "cg"):
        (fin, traj, infos), ms, launches, kc = drive("float64", {**TIGHT, "linear_solver": ls})
        require_launched(launches, used[ls], f"krylov tight {ls}")
        require(launches[unused[ls]] == 0, f"krylov tight {ls}: {unused[ls]} launched")
        u = traj["u"].cpu().numpy()[every - 1 :: every]
        scale = np.abs(gold["u"]).max()
        errs = {"u": np.abs(u - gold["u"]).max() / scale}
        for k in ("v", "a", "q", "p"):
            ref = gold[f"{k}_final"]
            errs[k] = np.abs(fin[k].cpu().numpy() - ref).max() / np.abs(ref).max()
        log(f"[krylov] tight {ls} f64 vs golden (JAX CPU): max|du|/max|u| {errs['u']:.3e},"
            f" final v {errs['v']:.3e}, a {errs['a']:.3e}, q {errs['q']:.3e},"
            f" p {errs['p']:.3e} (gates {GOLDEN_LARGE_GATES[ls]});"
            f" golden Newton {gold['num_iter'].tolist()}")
        log("[krylov] " + summary(f"tight {ls} f64", infos, ms, launches, kc))
        for k, e in errs.items():
            require(e <= GOLDEN_LARGE_GATES[ls][k],
                    f"krylov tight {ls}: {k} off the golden ({e:.3e})")
        tight[ls] = fin["u"].cpu().numpy()

    out = {}
    for ls in ("bsb", "cg"):
        finals = {}
        for tag in ("float64", "float32"):
            params = {**PROD, "linear_solver": ls}
            (fin, traj, infos), ms, launches, kc = drive(tag, params)
            require_launched(launches, used[ls], f"krylov prod {ls} {tag}")
            require(launches[unused[ls]] == 0, f"krylov prod {ls} {tag}: {unused[ls]} launched")
            ndof = models[tag][0].solid.ndof
            require(tuple(traj["u"].shape) == (n_steps, ndof), "krylov: bad shape")
            for k, v in traj.items():
                require(bool(torch.isfinite(v).all()), f"krylov prod {ls} {tag}: non-finite {k}")
            finals[tag] = fin["u"].double().cpu().numpy()
            traj_err = rel_max(finals[tag], tight[ls])
            log("[krylov] " + summary(f"prod {ls} {tag}", infos, ms, launches, kc)
                + f"; Newmark predictors {predictors(models[tag][0])}")
            log(f"[krylov] prod {ls} {tag}: trajectory error vs the tight f64 run"
                f" {traj_err:.3e} (f64 gate {traj_gate:.3e} = 10 x JAX CPU"
                f" {gold['prod_traj_err']:.3e})")
            if tag == "float64":
                require(traj_err <= traj_gate, f"krylov prod {ls}: trajectory error over its gate")
            out[(ls, tag)] = dict(launches=launches, steps_s=n_steps / (ms / 1e3),
                                  n_steps=n_steps)
        rel = rel_max(finals["float32"], finals["float64"])
        log(f"[krylov] prod {ls}: f32 vs f64 final u max rel diff {rel:.3e}"
            f" (gate {f32_gate:.3e} = 10 x JAX CPU {gold['prod_f32_vs_f64']:.3e})")
        require(rel <= f32_gate, f"krylov prod {ls}: f32 run outside its gate")
    # the profile runs the first quarter of the steps (an eager Krylov
    # step's host events take the profiler ~4 s to summarise)
    bsb_profile(torch, card, models["float64"], times[: (len(times) - 1) // 4 + 1])
    return out


def bsb_profile(torch, card, built, times):
    """One ``torch.profiler`` pass of the production bsb f64 run (after the
    runs above): K4's share of device busy and the idle share; then the ms
    per BiCGStab iteration at the run's middle state."""
    from vf_fem_tpu_torch import forward

    model, state0, cs, prop = built
    n_steps = len(times) - 1
    params = {**PROD, "linear_solver": "bsb"}
    traj = {}

    def run():
        traj.update(forward.integrate_pure(model, state0, cs, prop, times, params)[1])

    prof = profile_run(torch, run, n_steps, "bsb_matvec_kernel")
    require(prof["k_launches"] > 0, "bsb profile: no K4 kernel in the trace")
    state = {k: v[n_steps // 2 - 1] for k, v in traj.items()}
    prof["iter_ms"], prof["iters"] = krylov_iteration_ms(torch, built, state, params)
    log(f"[krylov] profile prod bsb f64, {n_steps} steps: {prof['per_step']:.1f} device"
        f" kernels per step (earlier: {EARLIER_PER_STEP['23.7k bsb']}), device busy"
        f" {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms profiled wall, idle share {prof['idle']:.3f}; K4 {prof['k_ms']:.3f} ms"
        f" ({prof['k_ms'] / prof['busy_ms']:.1%} of busy) in {prof['k_launches']} launches"
        f" ({prof['k_ms'] / prof['k_launches'] * 1e3:.2f} us each); at step {n_steps // 2}"
        f" a solve takes {prof['iters']} BiCGStab iterations, {prof['iter_ms']:.4f} ms each"
        f" (CUDA events), on {card}")
    log(prof["table"])


def step_split(torch, built, state, params, n_steps, step_ms):
    """Where a btd step's time goes, by CUDA events at ``state``: one
    residual, one solve and one refactorization, scaled by their counts per
    step (fixed-n chord: n solves, n residuals without the trailing one,
    n + 1 with it; a refactorization per refresh window, amortized)."""
    from vf_fem_tpu_torch.convert import to_tensors
    from vf_fem_tpu_torch.models.transient import solver_params

    model, _, _, prop = built
    solid = model.solid
    pd = solver_params(params)
    t_prop = to_tensors(prop, model.device, model.dtype)
    s0, ctrl, sprop = model._solid_inputs(state, t_prop)
    u_pred = solid._predictor(s0, DT)
    banded = solid.use_banded(pd)
    r = solid.res_u(u_pred, s0, ctrl, sprop, DT, banded)
    fac = solid.factorize(s0, ctrl, sprop, DT, pd)
    res_ms = cuda_ms(torch, lambda: solid.res_u(u_pred, s0, ctrl, sprop, DT, banded), 20, 1)
    fac_ms = cuda_ms(torch, lambda: solid.factorize(s0, ctrl, sprop, DT, pd), 3, 1)
    solve_ms = cuda_ms(torch, lambda: solid.solve_factors(fac, r, pd), 20, 1)
    n_fixed = int(pd["fixed_iterations"])
    n_res = n_fixed + (1 if pd.get("fixed_tail_residual", True) else 0)
    n_fac = -(-n_steps // int(pd["jacobian_refresh_steps"]))
    split = {"residuals": n_res * res_ms, "solves": n_fixed * solve_ms,
             "refresh": n_fac * fac_ms / n_steps}
    split["other"] = step_ms - sum(split.values())
    detail = (f"one residual {res_ms:.3f} ms, one solve {solve_ms:.3f} ms, one"
              f" refactorization {fac_ms:.3f} ms")
    return split, detail


def device_events(prof):
    """The trace's device events as ``(name, self device us)``: every event
    on the device that is neither hidden nor a user annotation, its self
    time its duration (0 for an asynchronous one), as ``key_averages()``
    reads them; taken from the raw trace, which is read in a second where
    ``key_averages()`` took 5-50 s a profile on an H100's host."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        out.append((e.name(), 0.0 if is_async else (e.end_ns() - e.start_ns()) / 1e3))
    return out


def device_table(events, busy_ms, rows=12):
    """The device kernels with the most self time: name, launches, ms and
    share of device busy."""
    agg = {}
    for name, us in events:
        n, t = agg.get(name, (0, 0.0))
        agg[name] = (n + 1, t + us)
    top = sorted(agg.items(), key=lambda kv: -kv[1][1])[:rows]
    lines = [f"{'device kernel':<72} {'launches':>9} {'ms':>10} {'busy':>6}"]
    lines += [f"{name[:72]:<72} {n:>9} {t / 1e3:>10.3f} {t / 1e3 / busy_ms:>6.1%}"
              for name, (n, t) in top]
    return "\n".join(lines)


def profile_run(torch, run, n_steps, kernel):
    """One run under ``torch.profiler``: device kernels per step, device
    busy time (the device events' self time), the idle share of the
    profiled wall time, the device time and launches of the kernels whose
    name holds ``kernel``, and each port kernel's launches in the trace
    (``traced``) beside the run's count of them (``counted``: the launch
    counters' delta, replays included)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    before = read_launches()
    # host and device activity: a trace of device activity alone lost a
    # step's kernel records in 3 of 8 profiled graph runs on an H100 (the
    # launch counts are held to the trace), none with both
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = read_launches()
    t1 = time.perf_counter()
    events = device_events(prof)
    busy_ms = sum(us for _, us in events) / 1e3
    n_dev = len(events)
    mine = [us for name, us in events if kernel in name]
    k_ms = sum(mine) / 1e3
    traced = {op: sum(1 for name, _ in events if trace in name)
              for op, trace in TRACE_NAMES.items()}
    require(n_dev > 0, "profile: no device kernel in the trace")
    table = device_table(events, busy_ms)
    log(f"[profile] {n_dev} device kernels traced, summarised in"
        f" {time.perf_counter() - t1:.1f} s")
    # a checkout that predates a counter counts none of its launches
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms,
                per_step=n_dev / n_steps, k_ms=k_ms, k_launches=len(mine),
                table=table, traced=traced,
                counted={op: after.get(op, 0) - before.get(op, 0) for op in TRACE_NAMES})


def require_traced(prof, names, what):
    """The profiled run's launch counts are the launches its trace shows,
    for each kernel of ``names`` (a replay adds its captured step's counts,
    so this holds that delta to the device's record)."""
    for op in names:
        require(prof["traced"][op] > 0 and prof["traced"][op] == prof["counted"][op],
                f"{what}: {op} launched {prof['traced'][op]} times in the trace,"
                f" counted {prof['counted'][op]}")
    log(f"[{what}] launches in the trace = the counters' ("
        + ", ".join(f"{op} {prof['traced'][op]}" for op in names) + ")")


def krylov_iteration_ms(torch, built, state, params, reps=5):
    """ms per BiCGStab iteration at ``state``: the solve of the Newton
    residual at the predictor with the factors there, by CUDA events over
    ``reps`` solves, over the iterations of one solve; returns (ms per
    iteration, iterations a solve)."""
    from vf_fem_tpu_torch.convert import to_tensors
    from vf_fem_tpu_torch.models.transient import solver_params

    model, _, _, prop = built
    solid = model.solid
    pd = solver_params(params)
    s0, ctrl, sprop = model._solid_inputs(state, to_tensors(prop, model.device, model.dtype))
    r = solid.res_u(solid._predictor(s0, DT), s0, ctrl, sprop, DT, solid.use_banded(pd))
    fac = solid.factorize(s0, ctrl, sprop, DT, pd)
    before = solid.krylov_counts["iterations"]
    solid.solve_factors(fac, r, pd)
    iters = solid.krylov_counts["iterations"] - before
    solve_ms = cuda_ms(torch, lambda: solid.solve_factors(fac, r, pd), reps, 1)
    return solve_ms / max(iters, 1), iters


def phase_btd(torch, card, models):
    """The block-Thomas direct path at 23.7k: the tight f64 run against
    the JAX package's golden, the production settings in f64 and f32 with
    the reference's trajectory gate, and a profiler pass."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_large_btd_explicit.npz"))
    times = gold["times"]
    n_steps = len(times) - 1
    every = int(gold["steps"][0])
    used = ("gather", "scatter", "newmark", "btd_sweep")

    def drive(tag, params):
        model, state0, cs, prop = models[tag]
        return run_timed(torch, model, lambda: forward.integrate_pure(
            model, state0, cs, prop, times, params))

    def check_path(what, launches, infos):
        require_launched(launches, used, what)
        require(launches["ebe_matvec"] == 0 and launches["bsb_matvec"] == 0,
                f"{what}: a Krylov kernel launched ({launches})")
        solves = int(infos.num_iter.sum())  # one linear solve per Newton iteration
        require(launches["btd_sweep"] == 2 * solves,
                f"{what}: {launches['btd_sweep']} K6 launches for {solves} solves")
        return solves

    (fin, traj, infos), ms, launches, _ = drive("float64", BTD_TIGHT)
    check_path("btd tight", launches, infos)
    u = traj["u"].cpu().numpy()[every - 1 :: every]
    errs = {"u": np.abs(u - gold["u"]).max() / np.abs(gold["u"]).max()}
    for k in ("v", "a", "q", "p"):
        errs[k] = rel_max(fin[k].cpu().numpy(), gold[f"{k}_final"])
    log(f"[btd] tight f64 vs golden (JAX CPU): max|du|/max|u| {errs['u']:.3e},"
        f" final v {errs['v']:.3e}, a {errs['a']:.3e}, q {errs['q']:.3e}, p {errs['p']:.3e}"
        f" (gates {GOLDEN_BTD_GATES}); Newton {int(infos.num_iter.sum())} iterations"
        f" (golden {int(gold['num_iter'].sum())}); {n_steps / (ms / 1e3):.2f} steps/s,"
        f" launches {launches}, on {card}")
    for k, e in errs.items():
        require(e <= GOLDEN_BTD_GATES[k], f"btd tight: {k} off the golden ({e:.3e})")
    require(np.array_equal(infos.num_iter.cpu().numpy(), gold["num_iter"]),
            "btd tight: Newton counts differ from the golden")

    out, finals = {}, {}
    for tag, jax_err in (("float64", float(gold["prod_traj_err"])),
                         ("float32", float(gold["prod_f32_traj_err"]))):
        drive(tag, BTD_PROD)  # warm-up
        (fin, traj, infos), ms, launches, _ = drive(tag, BTD_PROD)
        solves = check_path(f"btd prod {tag}", launches, infos)
        pred = predictors(models[tag][0])
        ndof = models[tag][0].solid.ndof
        require(tuple(traj["u"].shape) == (n_steps, ndof), "btd: bad shape")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"btd prod {tag}: non-finite {k}")
        log(f"[btd] prod {tag} (CUDA graph): {n_steps / (ms / 1e3):.2f} steps/s ({ms:.3f} ms /"
            f" {n_steps} steps, CUDA events); Newmark predictors {pred}; {solves} solves,"
            f" Newton {infos.num_iter.tolist()[:4]}..., launches {launches}"
            f" ({sum(launches.values()) / n_steps:.1f} per step), on {card}")
        (fin_x, _, infos_x), ms_x, launches_x, _ = drive(tag, BTD_EXACT)
        check_path(f"btd exact {tag}", launches_x, infos_x)
        finals[tag] = fin["u"].double().cpu().numpy()
        traj_err = rel_max(finals[tag], fin_x["u"].double().cpu().numpy())
        # the reference's gate, or 1.5x the JAX package's own CPU value of
        # the same runs where that already exceeds it
        gate = TRAJ_ERR_GATE if jax_err <= TRAJ_ERR_GATE else 1.5 * jax_err
        log(f"[btd] prod {tag}: trajectory error vs the exact-Jacobian run {traj_err:.3e}"
            f" (gate {gate:.1e}; JAX CPU {jax_err:.3e}); exact run"
            f" {n_steps / (ms_x / 1e3):.2f} steps/s")
        require(traj_err <= gate, f"btd prod {tag}: trajectory error over its gate")
        out[tag] = dict(launches=launches, steps_s=n_steps / (ms / 1e3), traj_err=traj_err,
                        n_steps=n_steps, exact_u=fin_x["u"].double().cpu().numpy(),
                        gate=gate)
    prod_err = rel_max(finals["float64"], gold["prod_u_final"])
    log(f"[btd] prod f64 final u vs the JAX package's (golden): {prod_err:.3e}"
        f" (gate {PROD_U_GATE:.3e})")
    require(prod_err <= PROD_U_GATE, "btd prod f64: final u off the JAX package's")
    rel = rel_max(finals["float32"], finals["float64"])
    f32_gate = 10 * float(gold["prod_f32_vs_f64"])
    log(f"[btd] prod: f32 vs f64 final u max rel diff {rel:.3e} (gate {f32_gate:.3e}"
        f" = 10 x JAX CPU {gold['prod_f32_vs_f64']:.3e})")
    require(rel <= f32_gate, "btd prod: f32 run outside its gate")

    model, state0, cs, prop = models["float64"]
    prof = profile_run(torch, lambda: forward.integrate_pure(
        model, state0, cs, prop, times, BTD_PROD), n_steps, "btd_sweep_kernel")
    log(f"[btd] profile prod f64, {n_steps} steps: {prof['per_step']:.1f} device kernels"
        f" per step (eager, earlier: {EARLIER_PER_STEP['23.7k btd']}), device busy"
        f" {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms profiled wall, idle share {prof['idle']:.3f}; K6 {prof['k_ms']:.3f} ms"
        f" ({prof['k_ms'] / prof['busy_ms']:.1%} of busy) in {prof['k_launches']} launches"
        f" ({prof['k_ms'] / max(prof['k_launches'], 1) * 1e3:.1f} us each), on {card}")
    require(prof["k_launches"] > 0, "btd profile: no K6 kernel in the trace")
    require_traced(prof, ("gather", "scatter", "newmark", "btd_sweep"), "btd")
    log(prof["table"])
    out["profile"] = {k: v for k, v in prof.items() if k != "table"}
    return out


def graph_entry(model, params):
    """The stats of the model's cached step graph for ``params``
    (``step_graph.graph_stats``); raises if there is none."""
    from vf_fem_tpu_torch import step_graph
    from vf_fem_tpu_torch.models.transient import solver_params

    key = step_graph.params_key(solver_params(params))
    stats = step_graph.graph_stats(model)
    require(key in stats, f"no step graph cached for {params}")
    return stats[key]


def replay_ms(torch, model, params, n_steps, batch=None):
    """The cached step graph alone (of a batched run: ``batch``, ``(B,
    batch_controls)``): ``n_steps`` replays of the rows its buffers hold
    (the last run's last chunk; the counter back to 0 after each chunk), by
    CUDA events, in ms a step; the rest of a graph run is its eager
    factorizations, the copies between chunks and host work."""
    from vf_fem_tpu_torch import step_graph
    from vf_fem_tpu_torch.models.transient import solver_params

    buf = model._step_graphs[step_graph.cache_key(solver_params(params), batch)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for n in range(n_steps):
        if n % step_graph.CHUNK == 0:
            buf.counter.zero_()
        buf.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_steps


def peak_memory(torch, run):
    """Peak device memory of ``run()`` above what was allocated before it
    (the model, and the cached step graph's buffers and pool), in bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def same_run(torch, a, b):
    """Two ``integrate_pure`` results bit for bit: final state, trajectory
    and infos."""
    (fa, ta, ia), (fb, tb, ib) = a, b
    return (all(torch.equal(fa[k], fb[k]) and torch.equal(ta[k], tb[k]) for k in ta)
            and all(torch.equal(x, y) for x, y in zip(ia, ib)))


def phase_integrate(torch, card, dev, large, btd_res):
    """``forward.integrate(model, None, ...)`` at full width, then the eager
    loop and the captured step in turns (f64: eager, graph, graph; f32:
    eager, graph): the M5 headline (960 dofs) and the 23.7k production btd
    config, 100 steps, f64 and f32.  Each graph run is held bit for bit to the eager run, its
    launch counts equal, and the entry point's certification and
    divergence flags equal the eager run's; then each run's gates and a
    profile of each path."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_large_btd_explicit.npz"))
    configs = (("M5 headline", HEADLINE, DT * np.arange(N_STEPS + 1)),
               ("23.7k btd", BTD_PROD, gold["times"]))
    out = {}
    for name, params, times in configs:
        used = ("gather", "scatter", "newmark") + (("btd_sweep",) if name == "23.7k btd" else ())
        n_steps = len(times) - 1
        finals = {}
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).replace("torch.", "")
            what = f"integrate {name} {tag}"
            model, state0, cs, prop = (build(torch, dev, "M5_3layers.msh", dtype)
                                       if name == "M5 headline" else large[tag])
            control = {k: v[0] for k, v in cs.items()}

            def eager(ts=times):
                return forward._integrate_eager(model, state0, cs, prop, ts, params)

            def graph(ts=times):
                return forward.integrate_pure(model, state0, cs, prop, ts, params)

            # the entry point a user calls; it captures the step where the
            # graph is not cached yet
            reset_launches()
            fin_i, info_i = forward.integrate(model, None, state0, [control], prop, times,
                                              newton_solver_prm=params, write=False)
            torch.cuda.synchronize()
            require_launched(read_launches(), ("gather", "scatter", "newmark"), what)
            entry = graph_entry(model, params)
            # f64 in turns eager, graph, graph; f32 eager then graph (the
            # bit-equality gate); no warm-up run: the entry point's run
            # above warmed the path.  Each turn's peak device memory above
            # what was allocated before it
            turns = []
            for which in (("eager", "graph", "graph") if dtype == torch.float64
                          else ("eager", "graph")):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                res, ms, launches, _ = run_timed(torch, model, eager if which == "eager" else graph)
                turns.append(dict(which=which, res=res, ms=ms, launches=launches,
                                  steps_s=n_steps / (ms / 1e3),
                                  peak=torch.cuda.max_memory_allocated() - base))
            ref = turns[0]
            for t in turns[1:]:
                require(same_run(torch, t["res"], ref["res"]),
                        f"{what}: a {t['which']} run is not bit-equal to the first eager run")
                require(t["launches"] == ref["launches"],
                        f"{what}: {t['which']} launches {t['launches']} != {ref['launches']}")
            fin_e, info_e = forward.finalize_run(model, None, state0, [control], prop, times,
                                                 None, params, *ref["res"], write=False)
            require(info_i["uncertified_steps"] == info_e["uncertified_steps"]
                    and info_i["diverged"] == info_e["diverged"],
                    f"{what}: flags {info_i['uncertified_steps']}, {info_i['diverged']} !="
                    f" eager {info_e['uncertified_steps']}, {info_e['diverged']}")
            require(all(np.array_equal(info_i["all"][k], info_e["all"][k]) for k in info_e["all"])
                    and all(np.array_equal(fin_i[k], fin_e[k]) for k in fin_e),
                    f"{what}: integrate's final state or infos differ from the eager run's")
            for k, v in ref["res"][1].items():
                require(bool(torch.isfinite(v).all()), f"{what}: non-finite {k}")
            # the profiles run the first PROFILE_STEPS steps (the host's
            # operator events of 100 eager steps take a minute to summarise)
            prof = {which: profile_run(torch, lambda fn=fn: fn(times[:PROFILE_STEPS + 1]),
                                       PROFILE_STEPS, "newmark_kernel")
                    for which, fn in (("eager", eager), ("graph", graph))}
            for which, p in prof.items():
                require_traced(p, used, f"{what} {which}")
            memory = {"eager": turns[0]["peak"], "graph": turns[1]["peak"],
                      "graph windowed": peak_memory(torch, lambda: forward._integrate_windowed(
                          model, state0, cs, prop, times, params, window=MEMORY_WINDOW))}
            alone = replay_ms(torch, model, params, n_steps)
            graph_ms = np.mean([t["ms"] for t in turns if t["which"] == "graph"])
            windows = -(-n_steps // int(params["jacobian_refresh_steps"]))
            pool = entry["pool_bytes"]
            traj_bytes = sum(v.numel() * v.element_size() for v in ref["res"][1].values())
            log(f"[integrate] {name} {tag}: steps/s by CUDA events, in turns "
                + ", ".join(f"{t['which']} {t['steps_s']:.2f}" for t in turns)
                + f"; graph bit-equal to eager (trajectory, infos, final state), launches"
                f" {ref['launches']} both ways ({sum(ref['launches'].values()) / n_steps:.1f} a"
                f" step); integrate: uncertified_steps {info_i['uncertified_steps']}, diverged"
                f" {info_i['diverged']} (eager: {info_e['uncertified_steps']},"
                f" {info_e['diverged']}); graph {entry['nodes']} nodes a step, capture"
                f" {entry['capture_ms']:.3f} ms, instantiate {entry['instantiate_ms']:.3f} ms,"
                f" pool {'not measured' if pool is None else f'{pool / 2**20:.1f} MB'},"
                f" {entry['captures']} capture(s), {entry['replays']} replays; on {card}")
            log(f"[integrate] {name} {tag}: peak device memory above the model's, in MB: "
                + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in memory.items())
                + f"; trajectory {traj_bytes / 2**20:.1f} MB; on {card}")
            log(f"[integrate] {name} {tag}: the step graph alone {alone:.4f} ms a step"
                f" ({1e3 / alone:.2f} steps/s, {n_steps} replays by CUDA events); the rest of a"
                f" graph run, {graph_ms - n_steps * alone:.3f} ms of {graph_ms:.3f}, is its"
                f" {windows} eager factorizations and refreshes and the host between replays")
            for which, p in prof.items():
                log(f"[integrate] {name} {tag} profile {which}: {p['per_step']:.1f} device kernels"
                    f" a step, device busy {p['busy_ms']:.3f} ms of {p['wall_ms']:.3f} ms profiled"
                    f" wall ({p['busy_ms'] / n_steps:.4f} ms a step), idle share {p['idle']:.3f};"
                    f" K5 {p['k_launches']} launches in the trace")
            finals[tag] = fin_i["u"].astype(np.float64)
            out[(name, tag)] = dict(turns=[{k: v for k, v in t.items() if k != "res"}
                                           for t in turns], replay_ms=alone,
                                    graph=entry, memory=memory,
                                    profile={w: {k: v for k, v in p.items() if k != "table"}
                                             for w, p in prof.items()})
            if (name, tag) == ("23.7k btd", "float64"):
                # the run phase 16 post-processes
                out[(name, tag)]["run"] = (state0, ref["res"][1], control, prop)
            if name == "23.7k btd":
                err = rel_max(finals[tag], btd_res[tag]["exact_u"])
                log(f"[integrate] {name} {tag}: trajectory error vs the exact-Jacobian run"
                    f" {err:.3e} (gate {btd_res[tag]['gate']:.1e})")
                require(err <= btd_res[tag]["gate"], f"{what}: trajectory error over its gate")
                if tag == "float64":
                    mid = {k: v[n_steps // 2 - 1] for k, v in ref["res"][1].items()}
                    eager_ms = turns[0]["ms"] / n_steps
                    split, detail = step_split(torch, large[tag], mid, params, n_steps, eager_ms)
                    log(f"[integrate] {name} {tag} eager step {eager_ms:.3f} ms = "
                        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                        + f" ms ({detail}, eager calls at step {n_steps // 2}); graph step"
                        f" {graph_ms / n_steps:.3f} ms")
        rel = rel_max(finals["float32"], finals["float64"])
        gate = (10 * JAX_CPU_F32_VS_F64 if name == "M5 headline"
                else 10 * float(gold["prod_f32_vs_f64"]))
        log(f"[integrate] {name}: f32 vs f64 final u max rel diff {rel:.3e} (gate {gate:.3e})")
        require(rel <= gate, f"integrate {name}: f32 run outside its gate")
        if name == "23.7k btd":
            err = rel_max(finals["float64"], gold["prod_u_final"])
            log(f"[integrate] {name} f64 final u vs the JAX package's (golden): {err:.3e}"
                f" (gate {PROD_U_GATE:.3e})")
            require(err <= PROD_U_GATE, f"integrate {name}: final u off the JAX package's")
    return out


def adjoint_loss(torch, seen):
    """benchmarks/benchmark_adjoint.py:89-94's loss, sum(q[-20:]^2) 1e-6,
    keeping the trajectory it was given in ``seen``."""
    def loss(traj, controls, prop, times):
        seen["traj"] = {k: v.detach() for k, v in traj.items()}
        return torch.sum(traj["q"][-20:] ** 2) * 1e-6

    return loss


def forward_loss(torch, built, times, params):
    """The no-grad forward of the loss, timed by CUDA events: (value,
    trajectory, ms)."""
    from vf_fem_tpu_torch import forward

    model, state0, cs, prop = built
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _, traj, _ = forward.integrate_pure(model, state0, cs, prop, times, params)
    value = torch.sum(traj["q"][-20:] ** 2) * 1e-6
    end.record()
    torch.cuda.synchronize()
    return float(value), traj, start.elapsed_time(end)


def grad_run(torch, built, times, params, control=None):
    """One value+grad run through the entry point ``adjoint.integrate_grad``
    with the launch and adjoint counts set to 0 just before, timed by CUDA
    events, with its peak device memory over what was allocated before."""
    from vf_fem_tpu_torch import adjoint

    model, state0, _, prop = built
    seen = {}
    solid = model.solid
    solid.adjoint_counts.update(solves=0, refine_iterations=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_launches()
    start.record()
    value, grads = adjoint.integrate_grad(model, adjoint_loss(torch, seen), state0,
                                          [control or model.control], prop, times, params)
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    for group in ("ini_state", "controls", "prop"):
        for k, g in grads[group].items():
            require(np.isfinite(g).all(), f"grad: non-finite gradient {group}/{k}")
    require(np.isfinite(grads["times"]).all(), "grad: non-finite gradient of the times")
    return dict(value=value, grads=grads, traj=seen["traj"], ms=start.elapsed_time(end),
                launches=launches, counts=dict(solid.adjoint_counts),
                peak=torch.cuda.max_memory_allocated() - base)


def grad_rel(a, b, value):
    """Per group, the largest max|a - b| / max|b| over its keys; a key whose
    gradient in ``b`` is below 1e-12 |value| (an analytically vanishing
    derivative's rounding) must be that small in ``a`` and is left out."""
    worst = {}
    for group in ("ini_state", "controls", "prop"):
        w = 0.0
        for k, gb in b[group].items():
            scale, floor = np.abs(gb).max(), 1e-12 * abs(value)
            if scale <= floor:
                require(np.abs(a[group][k]).max() <= floor,
                        f"grad: {group}/{k} is {np.abs(a[group][k]).max():.3e}, not ~0")
                continue
            w = max(w, float(np.abs(a[group][k] - gb).max() / scale))
        worst[group] = w
    worst["times"] = float(np.abs(a["times"] - b["times"]).max() / np.abs(b["times"]).max())
    return worst


def phase_grad(torch, card, dev, large):
    """Phase 9, the gradient path in f64: value+grad (``adjoint.integrate_grad``)
    of benchmarks/benchmark_adjoint.py's loss over 100 steps at dt = 1e-4,
    at M5 (ADJ_M5, its first GRAD_M5_STEPS steps) and at 23.7k (ADJ_LARGE, the stale-factor refined adjoint
    and the exact one)."""
    times = DT * np.arange(N_STEPS + 1)
    t_m5 = times[:GRAD_M5_STEPS + 1]
    out = {}
    # -- M5 ---------------------------------------------------------------------
    m5 = build(torch, dev, "M5_3layers.msh", torch.float64)
    model = m5[0]
    # central differences along psub and along a seeded random emod
    # direction; their forward runs come first and warm the path
    cp = {k: v.copy() for k, v in model.control.items()}
    psub_vals = []
    for h in (1.0, -1.0):
        cp["psub"] = model.control["psub"] + h
        psub_vals.append(forward_loss(torch, (model, m5[1], {k: v[None] for k, v in cp.items()},
                                              m5[3]), t_m5, ADJ_M5)[0])
    d = np.random.default_rng(9).standard_normal(model.prop["emod"].shape)
    emod_vals = []
    for h in (5.0, -5.0):
        p = {**model.prop, "emod": model.prop["emod"] + h * d}
        emod_vals.append(forward_loss(torch, (model, m5[1], m5[2], p), t_m5, ADJ_M5)[0])
    value_f, traj_f, ms_f = forward_loss(torch, m5, t_m5, ADJ_M5)
    g = grad_run(torch, m5, t_m5, ADJ_M5)
    require(g["value"] == value_f and all(torch.equal(g["traj"][k], traj_f[k]) for k in traj_f),
            "grad M5: the value+grad run's trajectory is not the forward's bit for bit")
    require_launched(g["launches"], ("gather", "scatter", "newmark", "newmark_t"), "grad M5")
    fwd_s, grad_s = GRAD_M5_STEPS / (ms_f / 1e3), GRAD_M5_STEPS / (g["ms"] / 1e3)
    log(f"[grad] M5 f64 ({model.solid.ndof} dofs), {GRAD_M5_STEPS} steps: forward loss"
        f" {fwd_s:.2f} steps/s ({ms_f:.3f} ms), value+grad {grad_s:.2f} steps/s"
        f" ({g['ms']:.3f} ms, CUDA events): gradient overhead {fwd_s / grad_s:.2f}x forward;"
        f" J = {g['value']:.9e} (= the forward's, trajectory bit for bit); adjoint solves"
        f" {g['counts']['solves']}, refinement iterations {g['counts']['refine_iterations']}"
        f" ({g['counts']['refine_iterations'] / max(g['counts']['solves'], 1):.2f} a solve);"
        f" peak device memory {g['peak'] / 1e6:.1f} MB over the model's; launches"
        f" {g['launches']}, on {card}")
    checks = [("psub (h = 1 Ba)", float(g["grads"]["controls"]["psub"].sum()),
               (psub_vals[0] - psub_vals[1]) / 2.0),
              ("emod along a random direction (5 Ba a cell)",
               float(np.dot(g["grads"]["prop"]["emod"], d)), (emod_vals[0] - emod_vals[1]) / 10.0)]
    for what, adj, fd in checks:
        rel = abs(adj - fd) / abs(fd)
        log(f"[grad] M5 d J / d {what}: adjoint {adj:.9e}, central difference {fd:.9e},"
            f" rel diff {rel:.3e} (rtol {FD_RTOL:.0e})")
        require(fd != 0 and rel <= FD_RTOL, f"grad M5: {what} off its finite difference")
    out["M5"] = dict(fwd_steps_s=fwd_s, grad_steps_s=grad_s, peak=g["peak"],
                     launches=g["launches"])
    # -- 23.7k ------------------------------------------------------------------
    big = large["float64"]
    forward_loss(torch, big, times, ADJ_LARGE)  # warm-up (captures the step)
    value_f, traj_f, ms_f = forward_loss(torch, big, times, ADJ_LARGE)
    g = grad_run(torch, big, times, ADJ_LARGE)  # after the forward's warm-up
    require(g["value"] == value_f and all(torch.equal(g["traj"][k], traj_f[k]) for k in traj_f),
            "grad 23.7k: the value+grad run's trajectory is not the forward's (graph) bit for bit")
    used = ("gather", "scatter", "newmark", "newmark_t", "btd_sweep", "btd_sweep_t")
    require_launched(g["launches"], used, "grad 23.7k")
    x = grad_run(torch, big, times, {**ADJ_LARGE, "adjoint_refine": "exact"})
    worst = grad_rel(g["grads"], x["grads"], x["value"])
    fwd_s, grad_s = N_STEPS / (ms_f / 1e3), N_STEPS / (g["ms"] / 1e3)
    per_step = {k: g["launches"][k] / N_STEPS for k in used}
    log(f"[grad] 23.7k f64 ({big[0].solid.ndof} dofs), {N_STEPS} steps: forward loss (CUDA"
        f" graph) {fwd_s:.2f} steps/s ({ms_f:.3f} ms), value+grad (stale refined)"
        f" {grad_s:.2f} steps/s ({g['ms']:.3f} ms): gradient overhead {fwd_s / grad_s:.2f}x"
        f" forward; exact-factor value+grad {N_STEPS / (x['ms'] / 1e3):.2f} steps/s;"
        f" J = {g['value']:.9e} (= the forward's, trajectory bit for bit); refinement"
        f" iterations {g['counts']['refine_iterations']} in {g['counts']['solves']} solves"
        f" ({g['counts']['refine_iterations'] / max(g['counts']['solves'], 1):.2f} a solve);"
        f" peak device memory {g['peak'] / 1e6:.1f} MB (exact {x['peak'] / 1e6:.1f} MB) over"
        f" the model's; launches a step {per_step}, on {card}")
    log(f"[grad] 23.7k stale vs exact gradient, max rel diff per group {worst}"
        f" (bound {STALE_VS_EXACT:.0e})")
    require(max(worst.values()) <= STALE_VS_EXACT, "grad 23.7k: stale gradient off the exact one")
    from vf_fem_tpu_torch import adjoint

    model = big[0]
    prof = profile_run(torch, lambda: adjoint.integrate_grad(
        model, adjoint_loss(torch, {}), big[1], [model.control], big[3],
        times[:PROFILE_STEPS + 1], ADJ_LARGE), PROFILE_STEPS, "btd_sweep_t_kernel")
    require_traced(prof, used, "grad")
    log(f"[grad] profile 23.7k value+grad f64, {PROFILE_STEPS} steps: {prof['per_step']:.1f} device"
        f" kernels per step, device busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms"
        f" profiled wall, idle share {prof['idle']:.3f}; K6T {prof['k_ms']:.3f} ms"
        f" ({prof['k_ms'] / prof['busy_ms']:.1%} of busy) in {prof['k_launches']} launches,"
        f" on {card}")
    log(prof["table"])
    out["23.7k"] = dict(fwd_steps_s=fwd_s, grad_steps_s=grad_s, peak=g["peak"],
                        launches=g["launches"], worst=worst, idle=prof["idle"])
    return out


def set_shape_props(model):
    """The properties and controls of tests/fixture_models.make_vf_fsi_model
    for KelvinVoigtWShape + BernoulliSmoothMinSep."""
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    p = model.prop
    for k, v in dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, ycontact=ymax + 0.05,
                     kcontact=1e8, rho_air=1.1225e-3, zeta_min=1e-3, zeta_sep=1e-3,
                     ymid=ymax + 0.01).items():
        if k in p:
            p[k][:] = v
    model.control["psub"][:] = 8000.0
    model.control["psup"][:] = 0.0


def phase_tangents(torch, card, dev, large):
    """Phase 10, tangents and the remaining adjoints at 23.7k in f64: (b)
    the 'cg' and 'bsb' value+grad (K3T / K4T in each step's transposed
    BiCGStab solve) against the exact btd gradient, with their launches
    held to a profiled run's trace; (c) ``forward.integrate_linear_pure``
    (bf16 btd factors, refresh 1; the tangent solves take f64 factors) in
    duality with ``adjoint.integrate_grad`` along emod and psub; (d)
    ``TractionShape`` on the card (banded: bsb fill, f64 btd factors, K6 /
    K6T solves, K1/K2 in T t and T^T lam): its certificate by K4, jvp
    linearity and vjp duality, then the composed shape gradient
    (KelvinVoigtWShape + BernoulliSmoothMinSep, integrate_grad with respect
    to umesh, then apply_vjp) against a central difference."""
    from vf_fem_tpu_torch import adjoint, forward, ops
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.parameters import transform as tf
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    times = DT * np.arange(TANGENT_STEPS + 1)
    big = large["float64"]
    model, s0, cs, prop = big
    ndof = model.solid.ndof
    out = {}
    # -- (b) the Krylov adjoints --------------------------------------------------
    ref = grad_run(torch, big, times, BTD_EXACT_GRAD)
    for ls, kern, fwd_kern in (("cg", "ebe_matvec_t", "ebe_matvec"),
                               ("bsb", "bsb_matvec_t", "bsb_matvec")):
        params = {**TIGHT, "linear_solver": ls}
        other = "bsb_matvec_t" if ls == "cg" else "ebe_matvec_t"
        kc = model.solid.krylov_counts
        kc.update(solves=0, iterations=0)
        g = grad_run(torch, big, times, params)
        worst = grad_rel(g["grads"], ref["grads"], ref["value"])
        used = ("gather", "scatter", "newmark", "newmark_t", fwd_kern, kern)
        require_launched(g["launches"], used, f"tangents {ls} value+grad")
        require(g["launches"][other] == 0, f"tangents {ls} value+grad: {other} launched")
        per_step = {k: g["launches"][k] / TANGENT_STEPS for k in used}
        log(f"[tangents] 23.7k {ls} f64 value+grad (Krylov tolerance"
            f" {params['krylov_tolerance']:.0e}, refresh 1), {TANGENT_STEPS} steps:"
            f" {TANGENT_STEPS / (g['ms'] / 1e3):.2f} steps/s ({g['ms']:.3f} ms, CUDA events),"
            f" J = {g['value']:.9e} (btd exact {ref['value']:.9e}); adjoint solves"
            f" {g['counts']['solves']}, Krylov {kc['iterations']} iterations in {kc['solves']}"
            f" solves; launches a step {per_step}; peak device memory {g['peak'] / 1e6:.1f} MB"
            f" over the model's, on {card}")
        log(f"[tangents] 23.7k {ls} gradient vs the exact btd gradient, max rel diff per"
            f" group {worst} (bound {KRYLOV_VS_EXACT:.0e})")
        require(max(worst.values()) <= KRYLOV_VS_EXACT,
                f"tangents {ls}: gradient off the exact btd one")
        prof = profile_run(torch, lambda: adjoint.integrate_grad(
            model, adjoint_loss(torch, {}), s0, [model.control], prop,
            times[:TANGENT_PROFILE_STEPS + 1], params), TANGENT_PROFILE_STEPS, kern + "_kernel")
        require_traced(prof, used, f"tangents {ls}")
        log(f"[tangents] profile 23.7k {ls} value+grad, {TANGENT_PROFILE_STEPS} steps:"
            f" {prof['per_step']:.1f} device kernels per step, device busy"
            f" {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms profiled wall, idle share"
            f" {prof['idle']:.3f}; {kern} {prof['k_ms']:.3f} ms"
            f" ({prof['k_ms'] / prof['busy_ms']:.1%} of busy) in {prof['k_launches']} launches")
        out[ls] = dict(launches=g["launches"], steps_s=TANGENT_STEPS / (g["ms"] / 1e3),
                       worst=worst, idle=prof["idle"])
    # -- (c) integrate_linear in duality with integrate_grad -----------------------
    rng = np.random.default_rng(10)
    h = torch.as_tensor(rng.standard_normal(ndof), device=dev)
    zero = lambda d: {k: np.zeros_like(v) for k, v in d.items()}  # noqa: E731
    directions = {
        "emod": (zero(s0), zero(cs), {**zero(prop),
                                      "emod": 5.0 * rng.standard_normal(prop["emod"].shape)}),
        "psub": (zero(s0), {**zero(cs), "psub": np.ones_like(cs["psub"])}, zero(prop)),
    }
    lin = {}
    for name, (ds0, dcs, dprop) in directions.items():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_launches()
        start.record()
        fin, dfin = forward.integrate_linear_pure(model, s0, cs, prop, times, ds0, dcs, dprop,
                                                  np.zeros_like(times), LINEAR_BTD)
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        require_launched(launches, ("gather", "scatter", "newmark", "btd_sweep"),
                         f"tangents integrate_linear {name}")
        for k, v in dfin.items():
            require(bool(torch.isfinite(v).all()), f"integrate_linear {name}: non-finite d{k}")
        ms = start.elapsed_time(end)
        lin[name] = dict(u=dfin["u"], launches=launches, ms=ms)
        log(f"[tangents] integrate_linear 23.7k f64 ({name} direction), {TANGENT_STEPS}"
            f" steps: {TANGENT_STEPS / (ms / 1e3):.2f} steps/s ({ms:.3f} ms, CUDA events);"
            f" launches a step {({k: v / TANGENT_STEPS for k, v in launches.items() if v})}")
    _, grads = adjoint.integrate_grad(model, lambda traj, c, p, t: torch.dot(h, traj["u"][-1]),
                                      s0, [model.control], prop, times, LINEAR_BTD)
    rhs = {"emod": float(np.dot(grads["prop"]["emod"], directions["emod"][2]["emod"])),
           "psub": float(np.sum(grads["controls"]["psub"]))}
    for name in directions:
        lhs = float(torch.dot(h, lin[name]["u"]))
        rel = abs(lhs - rhs[name]) / abs(rhs[name])
        log(f"[tangents] duality along {name}: <h, J x_dot> {lhs:.12e} (integrate_linear),"
            f" <J^T h, x_dot> {rhs[name]:.12e} (integrate_grad), rel diff {rel:.3e}"
            f" (rtol {DUALITY_RTOL:.0e})")
        require(rel <= DUALITY_RTOL, f"tangents: integrate_linear {name} off its duality")
    out["linear"] = lin["emod"]
    # -- (d) TractionShape on the card --------------------------------------------
    sm = load_fsi_model(os.path.join(REPO, "meshes", LARGE_MESH), slr.KelvinVoigtWShape,
                        flr.BernoulliSmoothMinSep, device=dev, dtype=torch.float64)
    set_shape_props(sm)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ts = tf.TractionShape(sm.solid)
    t1.record()
    torch.cuda.synchronize()
    require(ts._solver == "banded", f"TractionShape picked {ts._solver!r} at 23.7k")
    rng = np.random.default_rng(7)
    x = {"tmesh": 1e2 * rng.standard_normal(ndof)}
    reset_launches()
    y = ts.apply(x)
    torch.cuda.synchronize()
    launches = read_launches()
    require_launched(launches, ("gather", "scatter", "btd_sweep"), "TractionShape.apply")
    umesh = torch.as_tensor(y["umesh"], device=dev)
    Tt = ts.T_mv(torch.as_tensor(x["tmesh"], device=dev))
    K = ts.assemble_K_blocks()
    cert = float((ops.bsb_matvec(ts._plan, K, umesh, ts._fill.pattern) - Tt).norm() / Tt.norm())
    dx = {"tmesh": 10.0 * rng.standard_normal(ndof)}
    dy = ts.apply_jvp(x, dx)
    y2 = ts.apply({"tmesh": x["tmesh"] + dx["tmesh"]})
    lin_err = float(np.abs(y2["umesh"] - y["umesh"] - dy["umesh"]).max()
                    / np.abs(dy["umesh"]).max())
    hy = {"umesh": rng.standard_normal(ndof)}
    reset_launches()
    hx = ts.apply_vjp(x, hy)
    torch.cuda.synchronize()
    vjp_launches = read_launches()
    require_launched(vjp_launches, ("gather", "scatter", "btd_sweep_t"),
                     "TractionShape.apply_vjp")
    lhs, rhs = float(np.dot(hy["umesh"], dy["umesh"])), float(np.dot(hx["tmesh"], dx["tmesh"]))
    dual = abs(lhs - rhs) / abs(rhs)
    log(f"[tangents] TractionShape 23.7k (banded on the card; built and factored in"
        f" {t0.elapsed_time(t1):.1f} ms): certificate |K umesh - T t| / |T t| = {cert:.3e}"
        f" (K by K4; gate {CERTIFICATE_GATE:.0e}), jvp linearity {lin_err:.3e} (rtol"
        f" {TRANSFORM_LINEAR_RTOL:.0e}), vjp duality {dual:.3e} (rtol"
        f" {TRANSFORM_DUALITY_RTOL:.0e}); apply launches {launches}, apply_vjp launches"
        f" {vjp_launches}")
    require(cert <= CERTIFICATE_GATE, "TractionShape: solve certificate over its gate")
    require(lin_err <= TRANSFORM_LINEAR_RTOL, "TractionShape: jvp not linear")
    require(dual <= TRANSFORM_DUALITY_RTOL, "TractionShape: vjp off its duality")
    # the composed shape gradient: a traction scaled to max|umesh| = 1e-4 cm
    # (about 2% of an element), the loss of tests/test_functional.py:411-416
    x = {"tmesh": rng.standard_normal(ndof)}
    x["tmesh"] *= 1e-4 / np.abs(ts.apply(x)["umesh"]).max()
    s_s0 = {k: np.zeros_like(v) for k, v in sm.state0.items()}
    s_cs = {k: v[None] for k, v in sm.control.items()}

    def loss(traj, controls, p, t):
        return torch.sum(traj["u"][-1] ** 2) * 1e4 + 1e-6 * torch.sum(traj["q"] ** 2)

    def value(tvec):
        p = {**sm.prop, "umesh": ts.apply({"tmesh": tvec})["umesh"]}
        _, traj, _ = forward.integrate_pure(sm, s_s0, s_cs, p, SHAPE_TIMES, SHAPE_PARAMS)
        return float(loss(traj, None, None, None))

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    val, g = adjoint.integrate_grad(sm, loss, s_s0, [sm.control],
                                    {**sm.prop, "umesh": ts.apply(x)["umesh"]}, SHAPE_TIMES,
                                    SHAPE_PARAMS)
    g_t = ts.apply_vjp(x, {"umesh": g["prop"]["umesh"]})["tmesh"]
    end.record()
    torch.cuda.synchronize()
    require(np.isfinite(g_t).all() and np.linalg.norm(g_t) > 0, "shape gradient: not finite")
    d = rng.standard_normal(ndof)
    d /= np.linalg.norm(d)
    step = 1e-3 * np.linalg.norm(x["tmesh"])
    fd = (value(x["tmesh"] + step * d) - value(x["tmesh"] - step * d)) / (2 * step)
    adj = float(g_t @ d)
    rel = abs(adj - fd) / abs(fd)
    log(f"[tangents] shape gradient 23.7k (KelvinVoigtWShape + BernoulliSmoothMinSep,"
        f" {len(SHAPE_TIMES) - 1} steps, btd f64): value+grad and apply_vjp"
        f" {start.elapsed_time(end):.1f} ms; J = {val:.9e}; d J / d t along a random unit"
        f" direction: adjoint {adj:.9e}, central difference {fd:.9e} (h = {step:.3e}), rel"
        f" diff {rel:.3e} (rtol {SHAPE_FD_RTOL:.0e}), on {card}")
    require(fd != 0 and rel <= SHAPE_FD_RTOL, "shape gradient off its central difference")
    return out


def implicit_counts(model):
    """The implicit model's Picard and solid Newton iterations since its
    last reset (``ImplicitFSIModel.picard_counts``), as host numbers."""
    c = dict(model.picard_counts)
    model.picard_counts.update(steps=0, iterations=0, newton_iterations=0)
    return {k: int(v) for k, v in c.items()}


def phase_implicit(torch, card, dev):
    """Phase 11, implicit coupling and the static solvers: the M5 implicit
    bench leg in f64 (against golden_m5_implicit.npz) and f32, timed and
    profiled; the 23.7k implicit run on production btd factors against its
    exact-Jacobian run; the 23.7k static configuration (Picard over static
    btd Newton) against the golden's, and one backward of the static solve;
    M5 implicit value+grad against a central difference."""
    from vf_fem_tpu_torch import adjoint, forward, static

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_m5_implicit.npz"))
    times = gold["times"]
    n_steps = len(times) - 1
    every = int(gold["steps"][0])
    used = ("gather", "scatter", "newmark")
    out = {}

    def drive(built, params, times):
        model, state0, cs, prop = built
        implicit_counts(model)
        res = run_timed(torch, model, lambda: forward.integrate_pure(
            model, state0, cs, prop, times, params))
        return res + (implicit_counts(model),)

    # -- M5 implicit, f64 and f32 ---------------------------------------------------
    m5 = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        built = build(torch, dev, "M5_3layers.msh", dtype, fluid="BernoulliSmoothMinSep",
                      coupling="implicit")
        m5[tag] = built
        (fin, traj, infos), ms, launches, _, counts = drive(built, IMPLICIT, times)
        require_launched(launches, used, f"implicit M5 {tag}")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"implicit M5 {tag}: non-finite {k}")
        require(tuple(traj["u"].shape) == (n_steps, built[0].solid.ndof), "implicit: bad shape")
        picard = infos.num_iter.cpu().numpy()
        per_step = {k: launches[k] / n_steps for k in used}
        log(f"[implicit] M5 {tag} ({built[0].solid.ndof} dofs), {n_steps} steps: "
            f"{n_steps / (ms / 1e3):.2f} steps/s ({ms:.3f} ms, CUDA events); Picard"
            f" {picard.mean():.2f} iterations a step, solid Newton"
            f" {counts['newton_iterations'] / n_steps:.2f} a step"
            f" ({counts['newton_iterations'] / max(counts['iterations'], 1):.2f} a Picard"
            f" iteration); launches a step {per_step}, on {card}")
        out[tag] = dict(u=traj["u"].double().cpu().numpy()[every - 1 :: every], q=traj["q"],
                        launches=launches, steps_s=n_steps / (ms / 1e3), picard=picard)
        if dtype != torch.float64:
            continue
        u = out[tag]["u"]
        du = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(u, gold["u"])]
        dq = rel_max(traj["q"][-1].cpu().numpy(), gold["q_final"])
        same = int((picard == gold["num_iter"]).sum())
        log(f"[implicit] M5 f64 vs golden (JAX CPU): max|du|/max|u| every {every} steps"
            f" {[float(f'{x:.3e}') for x in du]}, final q {dq:.3e} (gate"
            f" {IMPLICIT_GOLDEN_GATE:.0e}); Picard counts equal the golden's in {same} of"
            f" {n_steps} steps (port {int(picard.sum())}, golden {int(gold['num_iter'].sum())}"
            f" in all); the golden's Picard loop stops above 1e-8 relative residual"
            f" first at step {int(np.argmax(gold['rel_err'] > 1e-8)) + 1}")
        require(max(du) <= IMPLICIT_GOLDEN_GATE and dq <= IMPLICIT_GOLDEN_GATE,
                "implicit M5 f64: off the golden")
        model, state0, cs, prop = built
        prof = profile_run(torch, lambda: forward.integrate_pure(
            model, state0, cs, prop, times[:IMPLICIT_PROFILE_STEPS + 1], IMPLICIT),
            IMPLICIT_PROFILE_STEPS, "newmark_kernel")
        require_traced(prof, used, "implicit")
        log(f"[implicit] profile M5 f64, {IMPLICIT_PROFILE_STEPS} steps: {prof['per_step']:.1f} device"
            f" kernels per step, device busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f}"
            f" ms profiled wall, idle share {prof['idle']:.3f}, on {card}")
        out["profile"] = {k: v for k, v in prof.items() if k != "table"}
    # f32 against f64: the final u within 10x the JAX package's own
    # difference, and so is every stored step before the golden's Picard
    # loop first stops above 1e-8 relative residual (after it the runs
    # leave the solution, and the JAX package's f32 and f64 runs differ by
    # ~1x max|u| at the end)
    steps32 = [float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(out["float32"]["u"], out["float64"]["u"])]
    jax32 = gold["f32_vs_f64_steps"]
    converged = int(np.argmax(gold["rel_err"] > 1e-8))  # steps before the first
    gated = [i for i, n in enumerate(gold["steps"]) if n <= converged] + [len(steps32) - 1]
    log(f"[implicit] M5 f32 vs f64 every {every} steps {[float(f'{x:.3e}') for x in steps32]}"
        f" (JAX CPU {[float(f'{x:.3e}') for x in jax32]}); gated at 10x JAX: steps"
        f" {[int(gold['steps'][i]) for i in gated]}")
    require(all(steps32[i] <= 10 * jax32[i] for i in gated),
            "implicit M5: f32 run outside its gates")

    # -- 23.7k implicit on production btd factors --------------------------------------
    big = build(torch, dev, LARGE_MESH, torch.float64, fluid="BernoulliSmoothMinSep",
                coupling="implicit")
    t_large = DT * np.arange(IMPLICIT_LARGE_STEPS + 1)
    (fin, traj, infos), ms, launches, _, counts = drive(big, IMPLICIT_BTD, t_large)
    used_btd = used + ("btd_sweep",)
    require_launched(launches, used_btd, "implicit 23.7k btd")
    for k, v in traj.items():
        require(bool(torch.isfinite(v).all()), f"implicit 23.7k: non-finite {k}")
    (fin_x, traj_x, infos_x), ms_x, launches_x, _, counts_x = drive(big, IMPLICIT_BTD_EXACT,
                                                                    t_large)
    err = rel_max(fin["u"].cpu().numpy(), fin_x["u"].cpu().numpy())
    err_all = rel_max(traj["u"].cpu().numpy(), traj_x["u"].cpu().numpy())
    per_step = {k: launches[k] / IMPLICIT_LARGE_STEPS for k in used_btd}
    log(f"[implicit] 23.7k btd prod + Aitken f64 ({big[0].solid.ndof} dofs),"
        f" {IMPLICIT_LARGE_STEPS} steps: {IMPLICIT_LARGE_STEPS / (ms / 1e3):.2f} steps/s"
        f" ({ms:.3f} ms, CUDA events); Picard {infos.num_iter.tolist()} (exact run"
        f" {infos_x.num_iter.tolist()}), solid Newton {counts['newton_iterations']} in"
        f" {counts['iterations']} Picard iterations; launches a step {per_step}; trajectory"
        f" error vs the exact-Jacobian run {err:.3e} final, {err_all:.3e} over all steps"
        f" (gate {TRAJ_ERR_GATE:.0e}); exact run {IMPLICIT_LARGE_STEPS / (ms_x / 1e3):.2f}"
        f" steps/s, on {card}")
    require(err <= TRAJ_ERR_GATE, "implicit 23.7k: trajectory error over its gate")
    out["23.7k"] = dict(launches=launches, steps_s=IMPLICIT_LARGE_STEPS / (ms / 1e3),
                        err=err)
    del big, traj, traj_x

    # -- 23.7k static ----------------------------------------------------------------
    sm = build(torch, dev, LARGE_MESH, torch.float64, solid="KelvinVoigt",
               fluid="BernoulliSmoothMinSep")[0]
    control = {"psub": np.array([STATIC_PSUB]), "psup": np.array([0.0])}
    sm.solid.bsb_plan()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    state, info = static.static_coupled_configuration_picard(sm, control, sm.prop,
                                                             STATIC_OPTIONS)
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    ms = start.elapsed_time(end)
    require_launched(launches, ("gather", "scatter", "btd_sweep"), "static 23.7k")
    du = rel_max(state["u"], gold["static_u"])
    dp = rel_max(state["p"], gold["static_p"])
    log(f"[implicit] static 23.7k f64 (Picard over static btd Newton): {ms / 1e3:.3f} s,"
        f" {info['num_iter']} Picard iterations (golden {int(gold['static_num_iter'])}),"
        f" |du| + |dp| {info['abs_err']:.3e}; K6 {launches['btd_sweep']} launches, launches"
        f" {launches}; max|du|/max|u| vs golden {du:.3e} (gate {STATIC_GOLDEN_GATE:.0e}),"
        f" p {dp:.3e}, on {card}")
    require(np.isfinite(state["u"]).all() and du <= STATIC_GOLDEN_GATE,
            "static 23.7k: off the golden")
    # one backward of the static solve at the configuration: the transposed
    # static solve (K6T), then the residual's vjp (K1/K2 as each other's)
    solid = sm.solid
    prop_t = {k: torch.as_tensor(sm.prop[k], dtype=torch.float64, device=dev)
              .requires_grad_(k == "emod") for k in solid.prop}
    p1 = sm._pressure_to_solid(torch.as_tensor(state["p"], device=dev)).requires_grad_()
    u1, _ = solid.solve_static_u1(torch.as_tensor(state["u"], device=dev), {"p1": p1},
                                  prop_t, STATIC_OPTIONS)
    u_bar = torch.as_tensor(np.random.default_rng(11).standard_normal(solid.ndof), device=dev)
    torch.cuda.synchronize()
    reset_launches()
    start.record()
    g_p1, g_emod = torch.autograd.grad(u1, (p1, prop_t["emod"]), u_bar)
    end.record()
    torch.cuda.synchronize()
    launches_b = read_launches()
    require_launched(launches_b, ("btd_sweep_t", "gather", "scatter"), "static backward")
    require(bool(torch.isfinite(g_p1).all() and torch.isfinite(g_emod).all()),
            "static backward: non-finite gradient")
    log(f"[implicit] static 23.7k solve_static_u1 backward: {start.elapsed_time(end):.3f} ms"
        f" (CUDA events; f64 factors at u1, one transposed btd solve); launches {launches_b},"
        f" on {card}")
    out["static"] = dict(launches=launches, backward_launches=launches_b, ms=ms,
                         iterations=info["num_iter"])
    del sm, solid, u1

    # -- M5 implicit value+grad (no warm-up: this model's runs above warmed it) --------
    from vf_fem_tpu_torch.models.transient import COUPLED_JAC_CHUNK

    built = m5["float64"]
    model = built[0]
    t_grad = DT * np.arange(IMPLICIT_GRAD_STEPS + 1)
    value_f, traj_f, ms_f = forward_loss(torch, built, t_grad, IMPLICIT)
    g = grad_run(torch, built, t_grad, IMPLICIT)
    require(g["value"] == value_f and all(torch.equal(g["traj"][k], traj_f[k]) for k in traj_f),
            "implicit grad: the value+grad run's trajectory is not the forward's bit for bit")
    require_launched(g["launches"], used, "implicit grad")
    vals = []
    for h in (1.0, -1.0):
        cp = {k: v[None] for k, v in model.control.items()}
        cp["psub"] = cp["psub"] + h
        vals.append(forward_loss(torch, (model, built[1], cp, built[3]), t_grad, IMPLICIT)[0])
    adj, fd = float(g["grads"]["controls"]["psub"].sum()), (vals[0] - vals[1]) / 2.0
    rel = abs(adj - fd) / abs(fd)
    n_state = sum(np.size(v) for v in model.state0.values())
    log(f"[implicit] M5 value+grad f64, {IMPLICIT_GRAD_STEPS} steps: forward"
        f" {IMPLICIT_GRAD_STEPS / (ms_f / 1e3):.2f} steps/s, value+grad"
        f" {IMPLICIT_GRAD_STEPS / (g['ms'] / 1e3):.2f} steps/s (CUDA events); dense coupled"
        f" Jacobian {n_state} x {n_state} by jacfwd in chunks of"
        f" {COUPLED_JAC_CHUNK}: peak device memory {g['peak'] / 1e6:.1f} MB over the model's;"
        f" dJ/dpsub adjoint {adj:.9e}, central difference {fd:.9e}, rel diff {rel:.3e}"
        f" (rtol {FD_RTOL:.0e}); launches {g['launches']}, on {card}")
    require(fd != 0 and rel <= FD_RTOL, "implicit grad: psub off its finite difference")
    out["grad"] = dict(launches=g["launches"], peak=g["peak"], rel=rel)
    return out


def physics_model(torch, dev, mesh_name, dtype, solid, fluid):
    """A model of the physics phase (``physics_values``; the 23.7k values on
    ``LARGE_MESH``) on ``meshes/<mesh_name>``, separating at the interface
    position of its ``PHYSICS_SEPARATION`` vertex: ``(model, state0,
    stacked controls, prop)`` and that position."""
    from vf_fem_tpu_torch import load
    from vf_fem_tpu_torch.mesh import derive_1d_interface, load_gmsh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    mesh = load_gmsh(os.path.join(REPO, "meshes", mesh_name))
    _, sdofs, _ = derive_1d_interface(mesh)
    idx_sep = load.separation_index(mesh, sdofs, PHYSICS_SEPARATION)
    require(idx_sep is not None, f"physics: {mesh_name} has no {PHYSICS_SEPARATION} vertex")
    model = load.load_fsi_model(mesh, getattr(slr, solid), getattr(flr, fluid),
                                fluid_kwargs={"idx_sep": idx_sep}, device=dev, dtype=dtype)
    set_values(model, *physics_values(mesh.coords[:, 1].max(), mesh_name == LARGE_MESH))
    state0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    controls = {k: v[None] for k, v in model.control.items()}
    return (model, state0, controls, model.prop), idx_sep


def uncertified(params, infos):
    """A run's uncertified fixed-iteration steps (without the warning that
    ``forward.integrate`` gives its caller)."""
    import warnings

    from vf_fem_tpu_torch import forward

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return forward.certify_fixed_iterations(params, forward._step_info(infos))


def phase_physics(torch, card, dev, head, btd_res, integ):
    """The residuals and fluids of slice 7 on the main path: the two M5
    models against the JAX package's f64 golden, then the 23.7k swelling
    model on the production btd settings in f64 and f32 against its
    exact-Jacobian run, each beside the KelvinVoigtWEpithelium run of the
    same settings (phases 5, 7 and 8)."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_m5_physics.npz"))
    cfg = json.loads(str(gold["config"]))
    require({k: cfg[k] for k in physics_config()} == json.loads(json.dumps(physics_config())),
            "physics: golden_m5_physics.npz holds another configuration")
    times = DT * np.arange(N_STEPS + 1)
    out = {}
    for tag, (solid, fluid) in PHYSICS_M5.items():
        built, idx_sep = physics_model(torch, dev, "M5_3layers.msh", torch.float64, solid, fluid)
        require(idx_sep == cfg[tag]["idx_sep"], f"physics {tag}: idx_sep {idx_sep} !="
                f" the golden's {cfg[tag]['idx_sep']}")
        model, state0, cs, prop = built
        run = lambda: forward.integrate_pure(model, state0, cs, prop, times, HEADLINE)
        (fin, traj, infos), ms_first, launches, _ = run_timed(torch, model, run)
        require_launched(launches, ("gather", "scatter", "newmark"), f"physics M5 {tag}")
        u = traj["u"].cpu().numpy()[::8]
        q = traj["q"].cpu().numpy().ravel()
        p_fin = traj["p"].cpu().numpy()[-1]
        errs = {"u": rel_max(u, gold[f"{tag}|u"]), "q": rel_max(q, gold[f"{tag}|q"]),
                "p": rel_max(p_fin, gold[f"{tag}|p_final"])}
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"physics M5 {tag}: non-finite {k}")
        np.testing.assert_allclose(u, gold[f"{tag}|u"], rtol=PHYSICS_GOLDEN_RTOL, atol=1e-12)
        np.testing.assert_allclose(q, gold[f"{tag}|q"], rtol=PHYSICS_GOLDEN_RTOL)
        np.testing.assert_allclose(p_fin, gold[f"{tag}|p_final"], rtol=PHYSICS_GOLDEN_RTOL,
                                   atol=1e-8)
        _, ms, _, _ = run_timed(torch, model, run)  # the captured step, replayed
        entry = graph_entry(model, HEADLINE)
        n_unc, j_unc = uncertified(HEADLINE, infos), int(gold[f"{tag}|uncertified"])
        same_iters = np.array_equal(infos.num_iter.cpu().numpy(), gold[f"{tag}|num_iter"])
        log(f"[physics] M5 {solid} + {fluid} (idx_sep {idx_sep}) f64, {N_STEPS} steps against"
            f" the JAX golden: max|du|/max|u| {errs['u']:.3e}, q {errs['q']:.3e}, final p"
            f" {errs['p']:.3e} (rtol {PHYSICS_GOLDEN_RTOL:.0e}); Newton counts as the golden's"
            f" {same_iters}; uncertified {n_unc} (JAX {j_unc}); {N_STEPS / (ms / 1e3):.2f}"
            f" steps/s (graph; first run with the capture {N_STEPS / (ms_first / 1e3):.2f}),"
            f" {entry['nodes']} nodes a step, launches {launches}; on {card}")
        require(same_iters, f"physics M5 {tag}: Newton counts differ from the golden's")
        out[tag] = dict(launches=launches, steps_s=N_STEPS / (ms / 1e3), errs=errs,
                        uncertified=(n_unc, j_unc), nodes=entry["nodes"])
    hl = head["float64"]
    log(f"[physics] beside phase 5's KelvinVoigtWEpithelium + BernoulliAreaRatioSep:"
        f" {hl['steps_s']:.2f} steps/s, launches {hl['launches']}")

    g23 = np.load(os.path.join(REPO, "tests", "data", "golden_physics_23k.npz"))
    require(json.loads(str(g23["config"])) == json.loads(json.dumps(physics_config())),
            "physics: golden_physics_23k.npz holds another configuration")
    solid, fluid = PHYSICS_LARGE
    used = ("gather", "scatter", "newmark", "btd_sweep")
    finals = {}
    for tag, jax_err, j_unc in (("float64", float(g23["traj_err"]), int(g23["uncertified"])),
                                ("float32", float(g23["f32_traj_err"]),
                                 int(g23["f32_uncertified"]))):
        dtype = getattr(torch, tag)
        built, idx_sep = physics_model(torch, dev, LARGE_MESH, dtype, solid, fluid)
        require(idx_sep == int(g23["idx_sep"]), "physics 23.7k: idx_sep off the golden's")
        model, state0, cs, prop = built

        def drive(params, eager=False):
            fn = forward._integrate_eager if eager else forward.integrate_pure
            return run_timed(torch, model, lambda: fn(model, state0, cs, prop, times, params))

        drive(BTD_PROD)  # warm-up: the capture
        (fin, traj, infos), ms, launches, _ = drive(BTD_PROD)
        require_launched(launches, used, f"physics 23.7k {tag}")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"physics 23.7k {tag}: non-finite {k}")
        _, ms_eager, launches_eager, _ = drive(BTD_PROD, eager=True)
        require(launches_eager == launches, f"physics 23.7k {tag}: eager launches"
                f" {launches_eager} != graph {launches}")
        alone = replay_ms(torch, model, BTD_PROD, N_STEPS)
        entry = graph_entry(model, BTD_PROD)
        (fin_x, _, infos_x), ms_x, launches_x, _ = drive(BTD_EXACT)
        require_launched(launches_x, used, f"physics 23.7k exact {tag}")
        finals[tag] = fin["u"].double().cpu().numpy()
        traj_err = rel_max(finals[tag], fin_x["u"].double().cpu().numpy())
        gate = TRAJ_ERR_GATE if jax_err <= TRAJ_ERR_GATE else 1.5 * jax_err
        per_step = {k: launches[k] / N_STEPS for k in used}
        kv = btd_res[tag]
        kv_int = integ[("23.7k btd", tag)]
        log(f"[physics] 23.7k {solid} + {fluid} (idx_sep {idx_sep}) prod {tag}:"
            f" {N_STEPS / (ms / 1e3):.2f} steps/s graph, {N_STEPS / (ms_eager / 1e3):.2f} eager"
            f" (CUDA events); the step graph alone {alone:.4f} ms a step, {entry['nodes']} nodes"
            f" a step; launches a step {per_step}; uncertified {uncertified(BTD_PROD, infos)}"
            f" (JAX {j_unc}); trajectory error vs the exact-Jacobian run {traj_err:.3e} (gate"
            f" {gate:.1e}; JAX CPU {jax_err:.3e}; exact run {N_STEPS / (ms_x / 1e3):.2f}"
            f" steps/s); on {card}")
        log(f"[physics] beside phases 7-8's KelvinVoigtWEpithelium + BernoulliAreaRatioSep"
            f" {tag}: {kv['steps_s']:.2f} steps/s graph, replay {kv_int['replay_ms']:.4f} ms a"
            f" step, {kv_int['graph']['nodes']} nodes a step, launches a step"
            f" { {k: kv['launches'][k] / kv['n_steps'] for k in used} }, trajectory error"
            f" {kv['traj_err']:.3e}")
        require(traj_err <= gate, f"physics 23.7k {tag}: trajectory error over its gate")
        out[("23.7k", tag)] = dict(launches=launches, steps_s=N_STEPS / (ms / 1e3),
                                   eager_steps_s=N_STEPS / (ms_eager / 1e3), replay_ms=alone,
                                   nodes=entry["nodes"], traj_err=traj_err, n_steps=N_STEPS)
    err = rel_max(finals["float64"], g23["u_final"])
    log(f"[physics] 23.7k prod f64 final u vs the JAX package's: {err:.3e} (gate"
        f" {PHYSICS_U_GATE:.1e}); f32 vs f64 {rel_max(finals['float32'], finals['float64']):.3e}"
        f" (JAX CPU {float(g23['f32_vs_f64']):.3e})")
    require(err <= PHYSICS_U_GATE, "physics 23.7k: final u off the JAX package's")
    return out


def stateful_run(m, times, options=None):
    """The reference's drive of a run: each step ``m.dt`` (the run's own
    step, as the eager loop takes it), ``solve_state1`` from the model's
    state, then ``set_ini_state``.  Returns the states and Newton counts."""
    states, iters = [], []
    state = m.state0
    for dt in np.diff(np.asarray(times, dtype=np.float64)):
        m.dt = float(dt)
        state, info = m.solve_state1(state, options)
        m.set_ini_state(state)
        states.append(state)
        iters.append(info["num_iter"])
    return states, iters


def api_golden(torch, dev):
    """The M5 CAD golden through the stateful loop: ``set_prop`` /
    ``set_control`` / ``dt``, then ``solve_state1`` and ``set_ini_state``
    each step, against ``golden_m5cad_explicit.npz`` and the eager loop of
    the same model; host ms a step of both."""
    import time

    from vf_fem_tpu_torch import forward

    data = np.load(os.path.join(REPO, "tests", "data", "golden_m5cad_explicit.npz"))
    times = data["times"]
    model, state0, cs, prop = build(torch, dev, "M5_CB_GA3.msh", torch.float64)
    m = model
    m.set_prop(prop)
    m.set_control({k: v[0] for k, v in cs.items()})
    m.set_ini_state(state0)
    torch.cuda.synchronize()
    reset_launches()
    m.solid.predictor_counts.update(carried=0, formed=0)
    t = time.perf_counter()
    states, iters = stateful_run(m, times)
    n_steps = len(states)
    ms = (time.perf_counter() - t) * 1e3 / n_steps
    launches = read_launches()
    preds = predictors(m)
    require_launched(launches, ("gather", "scatter", "newmark"), "api golden")
    t = time.perf_counter()
    _, traj, infos = forward._integrate_eager(m, state0, cs, prop, times)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3 / n_steps
    stateful = {k: np.stack([x[k] for x in states]) for k in states[0]}
    u = stateful["u"][::8]
    np.testing.assert_allclose(u, data["u"], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(stateful["q"].ravel(), data["q"], rtol=1e-8)
    np.testing.assert_allclose(stateful["p"][-1], data["p_final"], rtol=1e-8, atol=1e-8)
    eager = {k: v.cpu().numpy() for k, v in traj.items()}
    bit_equal = all(np.array_equal(stateful[k], eager[k]) for k in eager)
    worst = max(float(np.abs(stateful[k] - eager[k]).max() / max(np.abs(eager[k]).max(), 1e-300))
                for k in eager)
    require(worst <= API_EAGER_REL, f"api golden: stateful vs eager {worst:.3e}")
    require(iters == [int(x) for x in infos.num_iter.cpu()], "api golden: Newton counts differ")
    log(f"[api] M5_CB_GA3 golden through solve_state1 / set_ini_state, {n_steps} steps f64:"
        f" max|du| {np.abs(u - data['u']).max():.3e} (max|u| {np.abs(data['u']).max():.3e}),"
        f" against the eager loop {worst:.3e} (bit-equal {bit_equal}; gate {API_EAGER_REL:.0e}),"
        f" Newton iterations {sum(iters)} (eager the same); stateful {ms:.3f} ms a step, eager"
        f" {eager_ms:.3f} (host clock); predictors {preds}; launches {launches}")
    return dict(launches=launches, n_steps=n_steps, ms=ms, eager_ms=eager_ms,
                bit_equal=bit_equal, err=worst)


def _seed_solid(solid, seed=0):
    """The unit API test's draws (tests/test_transient_api.py:14-29) on a
    solid: state0 and state1 1e-4 N(0, 1), p1 500 U(0, 1), dt 1e-4; the
    contact plane API_CONTACT_DEPTH below the medial surface, so that the
    cubic penalty is engaged (without it the residual is affine in the
    state and the Taylor remainder is rounding alone)."""
    ymax = solid.residual.mesh().coords[:, 1].max()
    solid.prop["ycontact"][:] = ymax - API_CONTACT_DEPTH
    solid.set_prop(solid.prop)
    rng = np.random.default_rng(seed)
    for name, scale, normal in (("state0", 1e-4, True), ("state1", 1e-4, True),
                                ("control", 500.0, False)):
        vec = getattr(solid, name)
        getattr(solid, {"state0": "set_ini_state", "state1": "set_fin_state",
                        "control": "set_control"}[name])(
            {k: scale * (rng.standard_normal(v.size) if normal else rng.random(v.size))
             for k, v in vec.items()})
    solid.dt = 1e-4


def api_derivatives(torch, dev):
    """The derivative API at M5 width (M5_3layers, 960 dofs) in f64 on the
    card: each block of ``assem_res`` and the three ``assem_dres_d*``
    against the same calls on the CPU, Taylor orders, the
    ``solve_dres_dstate1`` round trip and the adjoint's duality."""
    import time

    from vf_fem_tpu_torch.misc.taylor import taylor_convergence
    from vf_fem_tpu_torch.models.dynamical import to_mono

    solids = {}
    for where in (dev, "cpu"):
        model = build(torch, where, "M5_3layers.msh", torch.float64)[0]
        solid = model.solid
        solid.set_prop({k: model.prop[k] for k in solid.prop})
        _seed_solid(solid)
        solids[str(where)] = solid
    card, host = solids[str(dev)], solids["cpu"]
    out = {}
    for name in ("assem_res", "assem_dres_dstate1", "assem_dres_dstate0", "assem_dres_dcontrol"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = getattr(card, name)()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        ref = getattr(host, name)()
        worst = 0.0
        for key, r in ref.items():
            r = np.asarray(r.cpu() if hasattr(r, "cpu") else r)
            g = np.asarray(got[key].cpu() if hasattr(got[key], "cpu") else got[key])
            scale = np.abs(r).max()
            err = float(np.abs(g - r).max() / scale) if scale > 0 else float(np.abs(g).max())
            worst = max(worst, err)
        require(worst <= API_CPU_REL, f"api {name}: card vs CPU {worst:.3e}")
        shape = (tuple(to_mono(got).shape) if name != "assem_res"
                 else (sum(v.size for v in got.values()),))
        out[name] = dict(err=worst, ms=ms)
        log(f"[api] M5_3layers {name} {shape}: card vs CPU {worst:.3e} of each block's largest"
            f" entry (gate {API_CPU_REL:.0e}), {ms:.1f} ms on the card")

    def flat(d):
        return np.concatenate([np.asarray(v).reshape(-1) for v in d.values()])

    def unflat(like, x):
        out, i = {}, 0
        for k, v in like.items():
            out[k] = x[i:i + v.size].reshape(v.shape)
            i += v.size
        return out

    rng = np.random.default_rng(1)
    for name, setter, assem, scale in (
            ("state1", card.set_fin_state, card.assem_dres_dstate1, 1e-5),
            ("state0", card.set_ini_state, card.assem_dres_dstate0, 1e-5),
            ("control", card.set_control, card.assem_dres_dcontrol, 1.0)):
        like = {k: v.copy() for k, v in getattr(card, name).items()}
        x0 = flat(like)
        dx = scale * rng.standard_normal(x0.size)

        def f(x, setter=setter, like=like):
            setter(unflat(like, x))
            return flat(card.assem_res())

        def jac(x, d, setter=setter, like=like, assem=assem):
            setter(unflat(like, x))
            return to_mono(assem()).cpu().numpy() @ d

        errors, _ = taylor_convergence(x0, dx, f, jac)
        rounding = 64 * np.finfo(np.float64).eps * float(np.linalg.norm(f(x0)))
        setter(like)
        rates = np.log2(errors[:-1] / errors[1:])
        # an affine residual (in state0 and p1) leaves a remainder of rounding
        # alone, which does not shrink with the step and says nothing of an
        # order: it must stay under the rounding of the residual
        affine = bool(errors[0] < 4 * errors[-1])
        require(errors.max() <= rounding if affine
                else float(np.min(rates)) >= API_TAYLOR_ORDER,
                f"api taylor d/d{name}: errors {errors}, orders {rates}")
        out[f"taylor {name}"] = rates
        log(f"[api] Taylor d/d{name} on the card: errors {np.array2string(errors, precision=3)},"
            f" orders {np.array2string(rates, precision=3)}"
            + (f" (affine: the remainder is rounding, under 64 eps |R| = {rounding:.3e})"
               if affine
               else f" (gate >= {API_TAYLOR_ORDER})"))

    A = card.assem_dres_dstate1()
    b = unflat(card.state1, rng.standard_normal(flat(card.state1).size))
    x = card.solve_dres_dstate1(A, card.state1, b)
    Ax = to_mono(A).cpu().numpy() @ flat(x)
    np.testing.assert_allclose(Ax, flat(b), **API_ROUNDTRIP)
    b2 = unflat(card.state1, rng.standard_normal(flat(card.state1).size))
    x2 = card.solve_dres_dstate1_adj(A, card.state1, b2)
    lhs, rhs = float(np.dot(flat(b2), flat(x))), float(np.dot(flat(x2), flat(b)))
    duality = abs(lhs - rhs) / abs(rhs)
    require(duality <= API_DUALITY_RTOL, f"api duality {duality:.3e}")
    rt = float(np.abs(Ax - flat(b)).max() / np.abs(flat(b)).max())
    log(f"[api] solve_dres_dstate1 round trip max|A x - b| / max|b| {rt:.3e} (gate rtol"
        f" {API_ROUNDTRIP['rtol']:.0e}, atol {API_ROUNDTRIP['atol']:.0e}); adjoint duality"
        f" {duality:.3e} (gate {API_DUALITY_RTOL:.0e})")
    out.update(roundtrip=rt, duality=duality)
    return out


def api_large(torch, large):
    """``solve_state1`` at 23.7k in f64: 5 stateful steps with each of
    'btd' (K6), 'bsb' (K4) and 'cg' (K3), each against the eager loop on
    the same settings at refresh 1, with the kernels each must launch."""
    import time

    from vf_fem_tpu_torch import forward

    model, state0, cs, prop = large
    m = model
    m.set_prop(prop)
    m.set_control({k: v[0] for k, v in cs.items()})
    times = DT * np.arange(API_LARGE_STEPS + 1)
    out = {}
    for solver, (params, kernel) in API_LARGE.items():
        m.set_ini_state(state0)
        m.solid.krylov_counts.update(solves=0, iterations=0)
        m.solid.predictor_counts.update(carried=0, formed=0)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        states, iters = stateful_run(m, times, params)
        ms = (time.perf_counter() - t) * 1e3 / API_LARGE_STEPS
        launches = read_launches()
        krylov = dict(m.solid.krylov_counts)
        preds = predictors(m)
        what = f"api 23.7k solve_state1 {solver}"
        require_launched(launches, ("gather", "scatter", "newmark", kernel), what)
        t = time.perf_counter()
        _, traj, infos = forward._integrate_eager(m, state0, cs, prop, times, params)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t) * 1e3 / API_LARGE_STEPS
        eager = {k: v.cpu().numpy() for k, v in traj.items()}
        stateful = {k: np.stack([x[k] for x in states]) for k in eager}
        require(all(np.isfinite(v).all() for v in stateful.values()), f"{what}: non-finite")
        bit_equal = all(np.array_equal(stateful[k], eager[k]) for k in eager)
        worst = max(float(np.abs(stateful[k] - eager[k]).max()
                          / max(np.abs(eager[k]).max(), 1e-300)) for k in eager)
        require(worst <= API_EAGER_REL, f"{what}: against the eager loop {worst:.3e}")
        log(f"[api] 23.7k solve_state1 {solver}, {API_LARGE_STEPS} steps f64: against the eager"
            f" loop {worst:.3e} (bit-equal {bit_equal}), Newton {iters} (eager"
            f" {[int(x) for x in infos.num_iter.cpu()]}), Krylov {krylov}, predictors {preds};"
            f" {ms:.2f} ms a step (eager {eager_ms:.2f}, host clock); launches {launches}")
        out[solver] = dict(launches=launches, n_steps=API_LARGE_STEPS, ms=ms, eager_ms=eager_ms,
                           bit_equal=bit_equal, err=worst)
    return out


def api_postprocess(torch, large, integ):
    """``TimeSeries`` of every measure of tests/test_functional.py:100-119
    and ``FieldStats(StressVonMisesField)`` over phase 8's 23.7k production
    f64 run (101 states, in memory), on the card: against its per-state
    loop on the card and the same series on the CPU."""
    import time

    from vf_fem_tpu_torch.postprocess import TimeSeries
    from vf_fem_tpu_torch.postprocess import solid as psl

    state0, traj, control, prop = integ[("23.7k btd", "float64")]["run"]
    card_model = large[0]
    host_model = build(torch, "cpu", LARGE_MESH, torch.float64)[0]
    readers = (RunReader(state0, traj, control, prop),
               RunReader(state0, {k: v.cpu() for k, v in traj.items()}, control, prop))

    def measures(model):
        out = {name: getattr(psl, name)(model) for name in API_MEASURES}
        out["FieldStats(StressVonMisesField)"] = psl.FieldStats(
            model, psl.StressVonMisesField(model))
        return out

    def worst_rel(a, b, scale=None):
        if isinstance(b, dict):
            # FieldStats: its max, min and avg at the field's scale (the
            # least-stressed cell's value comes from a cancellation), its
            # total at its own
            field = np.abs(b["max"]).max()
            return max(worst_rel(a[k], b[k], None if k == "total" else field) for k in b)
        scale = np.abs(b).max() if scale is None else scale
        return float(np.abs(a - b).max() / scale) if scale > 0 else float(np.abs(a).max())

    card_ms, rows = {}, []
    for (name, meas), host_meas in zip(measures(card_model).items(),
                                       measures(host_model).values()):
        series = TimeSeries(meas)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = series(readers[0])
        torch.cuda.synchronize()
        card_ms[name] = (time.perf_counter() - t) * 1e3
        loop = series.assem_loop(readers[0], range(readers[0].size))
        host = TimeSeries(host_meas)(readers[1])
        err_loop, err_host = worst_rel(got, loop), worst_rel(got, host)
        finite = (all(np.isfinite(v).all() for v in got.values()) if isinstance(got, dict)
                  else bool(np.isfinite(got).all()))
        require(finite, f"api series {name}: non-finite")
        require(err_loop <= SERIES_REL and err_host <= SERIES_REL,
                f"api series {name}: vmap vs loop {err_loop:.3e}, card vs CPU {err_host:.3e}")
        rows.append(f"{name} {card_ms[name]:.2f} ms ({err_loop:.1e} / {err_host:.1e})")
    log(f"[api] 23.7k TimeSeries of {len(rows)} measures over {readers[0].size} states f64 on"
        f" the card, ms a series (vmap vs loop / card vs CPU, gate {SERIES_REL:.0e} of each"
        f" series' largest entry, FieldStats' max, min and avg of the field's): "
        + "; ".join(rows))
    return card_ms


def api_phonation(torch, dev, card):
    """The M5 CAD model at psub 6000 Ba (``PHONATION``), 1,200 steps on the
    headline settings in the step graph: the minimum glottal width's
    series on the card and its f0 against the JAX package's f64 CPU run
    (``tests/data/golden_phonation_m5.npz``)."""
    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.misc.signal import fundamental_mode_from_rfft, is_oscillating
    from vf_fem_tpu_torch.postprocess import TimeSeries
    from vf_fem_tpu_torch.postprocess.solid import MinGlottalWidthFromSolid

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_phonation_m5.npz"))
    cfg = PHONATION
    model, state0, _, prop = build(torch, dev, cfg["mesh"], torch.float64, cfg["solid"],
                                   cfg["fluid"])
    model.control["psub"][:] = cfg["psub"]
    cs = {k: v[None] for k, v in model.control.items()}
    n_steps, dt = cfg["n_steps"], cfg["dt"]
    times = dt * np.arange(n_steps + 1)

    def run():
        return forward.integrate_pure(model, state0, cs, prop, times, HEADLINE)

    run()  # warm-up: captures the step
    (_, traj, infos), ms, launches, _ = run_timed(torch, model, run)
    reader = RunReader(state0, traj, model.control, prop)
    gw = TimeSeries(MinGlottalWidthFromSolid(model))(reader)[1:]
    require(np.isfinite(gw).all(), "api phonation: non-finite width")
    steady = gw[n_steps // 3:]
    f0, amp = fundamental_mode_from_rfft(steady, dt)
    bin_hz = 1.0 / (len(steady) * dt)
    ref = gold["gw"]
    dev_gw = float(np.abs(gw[:PHONATION_GW_STEPS] - ref[:PHONATION_GW_STEPS]).max()
                   / np.abs(ref).max())
    dev_all = float(np.abs(gw - ref).max() / np.abs(ref).max())
    log(f"[api] phonation M5_CB_GA3 psub {cfg['psub']:.0f} Ba, {n_steps} steps at dt {dt:g} f64"
        f" (graph): f0 {f0:.3f} Hz (JAX CPU {float(gold['f0']):.3f}; rfft bin {bin_hz:.3f} Hz),"
        f" amplitude {amp:.5e} cm (JAX {float(gold['amplitude']):.5e}), oscillating"
        f" {is_oscillating(gw)}; width vs JAX over {PHONATION_GW_STEPS} steps {dev_gw:.3e} of"
        f" max|gw| (gate {PHONATION_GW_REL:.0e}), over all {dev_all:.3e}; gw in"
        f" [{gw.min():.4e}, {gw.max():.4e}] cm; {n_steps / (ms / 1e3):.2f} steps/s (CUDA events),"
        f" launches {launches}; on {card}")
    require(abs(f0 - float(gold["f0"])) <= bin_hz, "api phonation: f0 off the JAX run's")
    require(dev_gw <= PHONATION_GW_REL, "api phonation: width off the JAX run's")
    require(amp > 1e-4, "api phonation: no oscillation")
    return dict(launches=launches, n_steps=n_steps, f0=f0, steps_s=n_steps / (ms / 1e3))


def phase_api(torch, card, dev, large, integ):
    """Phase 16: the stateful model API and the post-processing (the
    functions above, in order)."""
    return dict(golden=api_golden(torch, dev), derivatives=api_derivatives(torch, dev),
                large=api_large(torch, large["float64"]),
                series_ms=api_postprocess(torch, large["float64"], integ),
                phonation=api_phonation(torch, dev, card))


def build_fsai(torch, dev, dtype, large=False):
    """An FSAI model (``load.load_fsai_model``): the M5 golden's
    configuration (tests/make_golden_fsai.py), or with ``large`` the 23.7k
    production btd model with bench.py's properties, both in the golden's
    tract with the contact plane below the midline; ``(model, state0,
    stacked controls, prop)``."""
    from vf_fem_tpu_torch.load import load_fsai_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_m5_fsai.npz"))
    cfg = json.loads(str(gold["config"]))
    mesh, solid = ((os.path.join("meshes", LARGE_MESH), "KelvinVoigtWEpithelium") if large
                   else (cfg["mesh"], cfg["solid"]))
    model = load_fsai_model(os.path.join(REPO, mesh), getattr(slr, solid),
                            getattr(flr, cfg["fluid"]), num_tube=cfg["num_tube"],
                            device=dev, dtype=dtype)
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    p = model.prop
    if large:
        set_bench_props(model)
    else:
        for k, v in cfg["props"].items():
            p[k][:] = v
        model.control["psub"][:] = cfg["psub"]
    p["ycontact"][:] = ymax + cfg["ycontact_above_ymax"]
    p["ymid"][:] = ymax + cfg["ymid_above_ymax"]
    p["area"][:] = cfg["tract_area"]
    p["proploss"][:] = cfg["proploss"]
    require(model.check_envelope(), "fsai: the configuration leaves the envelope")
    state0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    return model, state0, {k: v[None] for k, v in model.control.items()}, model.prop


def fsai_value(torch, built, times, params):
    """The no-grad forward of the RMS radiated pressure, as
    ``adjoint.integrate_grad`` evaluates it (the trajectory with its initial
    row, float64 times on the device), timed by CUDA events: (value, ms)."""
    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.convert import to_tensors
    from vf_fem_tpu_torch.functional.acoustic import RmsRadiatedPressure

    model, state0, cs, prop = built
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _, traj, _ = forward.integrate_pure(model, state0, cs, prop, times, params)
    s0 = to_tensors(state0, model.device, model.dtype)
    full = {k: torch.cat([s0[k][None], traj[k]], 0) for k in traj}
    times_t = torch.as_tensor(np.asarray(times, dtype=np.float64)).to(model.device)
    value = RmsRadiatedPressure(model).eval_traj(full, times_t, None,
                                                  to_tensors(prop, model.device, model.dtype))
    end.record()
    torch.cuda.synchronize()
    return float(value), start.elapsed_time(end)


def fsai_grad_run(torch, built, times, params):
    """Value+grad of the RMS radiated pressure through
    ``adjoint.integrate_grad`` with the launch and adjoint counts set to 0
    just before, timed by CUDA events, with its peak device memory over what
    was allocated before; every gradient finite."""
    from vf_fem_tpu_torch import adjoint
    from vf_fem_tpu_torch.functional.acoustic import RmsRadiatedPressure

    model, state0, cs, prop = built
    model.solid.adjoint_counts.update(solves=0, refine_iterations=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_launches()
    start.record()
    value, grads = adjoint.integrate_grad(model, RmsRadiatedPressure(model), state0,
                                          [{k: v[0] for k, v in cs.items()}], prop, times,
                                          params)
    end.record()
    torch.cuda.synchronize()
    for group in ("ini_state", "controls", "prop"):
        for k, g in grads[group].items():
            require(np.isfinite(g).all(), f"fsai grad: non-finite gradient {group}/{k}")
    return dict(value=value, grads=grads, ms=start.elapsed_time(end), launches=read_launches(),
                peak=torch.cuda.max_memory_allocated() - base,
                counts=dict(model.solid.adjoint_counts))


def fsai_grad_large(torch, card, built, times):
    """Value+grad of the RMS radiated pressure through the 23.7k FSAI model
    on the production adjoint settings (ADJ_LARGE: bf16 btd factors refreshed
    every 16 steps, fixed-3, the refined stale-factor adjoint on K6T), the
    value the forward's (a graph run) bit for bit, the gradient against the
    exact-factor one (STALE_VS_EXACT per group)."""
    forward_value = fsai_value(torch, built, times, ADJ_LARGE)[0]  # captures the step
    value_f, ms_f = fsai_value(torch, built, times, ADJ_LARGE)
    g = fsai_grad_run(torch, built, times, ADJ_LARGE)
    x = fsai_grad_run(torch, built, times, {**ADJ_LARGE, "adjoint_refine": "exact"})
    n = len(times) - 1
    used = ("gather", "scatter", "newmark", "newmark_t", "btd_sweep", "btd_sweep_t")
    require(g["value"] == value_f == forward_value,
            f"fsai grad 23.7k: value {g['value']!r} != the forward's {value_f!r}")
    require_launched(g["launches"], used, "fsai grad 23.7k")
    worst = grad_rel(g["grads"], x["grads"], x["value"])
    per_step = {k: g["launches"][k] / n for k in used}
    log(f"[fsai] 23.7k value+grad f64 of the RMS radiated pressure over {n} steps: forward"
        f" (CUDA graph) {n / (ms_f / 1e3):.2f} steps/s, value+grad (stale refined)"
        f" {n / (g['ms'] / 1e3):.2f} steps/s, exact-factor {n / (x['ms'] / 1e3):.2f} (CUDA"
        f" events); J = {g['value']:.9e} (= the forward's); refinement iterations"
        f" {g['counts']['refine_iterations']} in {g['counts']['solves']} solves; stale vs exact"
        f" gradient, max rel diff per group {worst} (bound {STALE_VS_EXACT:.0e}); peak device"
        f" memory {g['peak'] / 2**20:.1f} MB over the model's; launches a step {per_step},"
        f" on {card}")
    require(max(worst.values()) <= STALE_VS_EXACT,
            "fsai grad 23.7k: stale gradient off the exact one")
    return dict(launches=g["launches"], steps_s=n / (g["ms"] / 1e3), worst=worst)


def phase_fsai(torch, card, dev):
    """Phase 12, two-way fluid-solid-acoustic coupling: the M5 FSAI model
    through ``forward.integrate`` and the eager loop and the captured step in
    turns, f64 against golden_m5_fsai.npz and f32 against its JAX f32 run,
    with the step graph's nodes and replay time beside the uncoupled FSI
    step's (the root solve's share), a profile and the peak memory; the
    23.7k production btd model in the tract against its exact-Jacobian run,
    and its value+grad; M5 value+grad of the RMS radiated pressure against
    central differences."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_m5_fsai.npz"))
    times = gold["times"]
    n_steps = len(times) - 1
    every = int(gold["steps"][0])
    used = ("gather", "scatter", "newmark")
    out = {}
    m5 = {}
    # -- M5, f64 and f32 -------------------------------------------------------------
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        what = f"fsai M5 {tag}"
        built = build_fsai(torch, dev, dtype)
        m5[tag] = built
        model, state0, cs, prop = built
        control = {k: v[0] for k, v in cs.items()}

        def eager(ts=times):
            return forward._integrate_eager(model, state0, cs, prop, ts, HEADLINE)

        def graph(ts=times):
            return forward.integrate_pure(model, state0, cs, prop, ts, HEADLINE)

        reset_launches()
        fin_i, info_i = forward.integrate(model, None, state0, [control], prop, times,
                                          newton_solver_prm=HEADLINE, write=False)
        torch.cuda.synchronize()
        require_launched(read_launches(), used, what)
        require(info_i["lagged_fallback_steps"] == 0 and not info_i["diverged"],
                f"{what}: {info_i['lagged_fallback_steps']} lagged steps, diverged"
                f" {info_i['diverged']}")
        entry = graph_entry(model, HEADLINE)
        # f64 in turns eager, graph, graph; f32 eager then graph (the
        # bit-equality gate); no warm-up run: the entry point's run above
        # warmed the path
        turns = []
        for which in (("eager", "graph", "graph") if dtype == torch.float64
                      else ("eager", "graph")):
            res, ms, launches, _ = run_timed(torch, model, eager if which == "eager" else graph)
            turns.append(dict(which=which, res=res, ms=ms, launches=launches,
                              steps_s=n_steps / (ms / 1e3)))
        ref = turns[0]
        for t in turns[1:]:
            require(same_run(torch, t["res"], ref["res"]),
                    f"{what}: a {t['which']} run is not bit-equal to the first eager run")
            require(t["launches"] == ref["launches"],
                    f"{what}: {t['which']} launches {t['launches']} != {ref['launches']}")
        fin, traj, infos = turns[1]["res"]
        require(bool(infos.bracketed.all()), f"{what}: a step fell back to the lagged exchange")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"{what}: non-finite {k}")
        require(all(np.array_equal(fin_i[k], fin[k].cpu().numpy()) for k in fin_i),
                f"{what}: integrate's final state differs from the graph run's")
        u = traj["u"].double().cpu().numpy()[every - 1 :: every]
        if dtype == torch.float64:
            du = rel_max(u, gold["u"])
            dq = rel_max(traj["q"].cpu().numpy().ravel(), gold["q"])
            finals = {k: rel_max(fin[k].cpu().numpy(), gold[f"{k}_final"])
                      for k in ("p", "pinc", "pref")}
            log(f"[fsai] M5 f64 vs golden (JAX CPU): max|du|/max|u| {du:.3e}, q {dq:.3e},"
                f" final {', '.join(f'{k} {v:.3e}' for k, v in finals.items())}"
                f" (rtol {FSAI_GOLDEN_RTOL:.0e}); Newton iterations equal the golden's:"
                f" {np.array_equal(infos.num_iter.cpu().numpy(), gold['num_iter'])}")
            np.testing.assert_allclose(u, gold["u"], rtol=FSAI_GOLDEN_RTOL, atol=1e-12)
            np.testing.assert_allclose(traj["q"].cpu().numpy().ravel(), gold["q"],
                                       rtol=FSAI_GOLDEN_RTOL)
            for k in ("p", "pinc", "pref"):
                ref_k = gold[f"{k}_final"]
                np.testing.assert_allclose(fin[k].cpu().numpy(), ref_k, rtol=FSAI_GOLDEN_RTOL,
                                           atol=1e-12 * np.abs(ref_k).max())
        else:
            diff = [float(np.abs(a - b).max() / np.abs(c).max())
                    for a, b, c in zip(u, gold["f32_u"], gold["u"])]
            gates = 10 * gold["f32_vs_f64_steps"]
            log(f"[fsai] M5 f32 vs the JAX f32 run every {every} steps"
                f" {[float(f'{x:.3e}') for x in diff]} (gates, 10x JAX f32 vs f64:"
                f" {[float(f'{x:.3e}') for x in gates]})")
            require(all(d <= g for d, g in zip(diff, gates)), "fsai M5 f32: outside its gates")
        # the uncoupled FSI step at the same settings: what the root solve
        # and the tract add to the captured step
        fsi = model.fsi
        fsi_args = ({k: state0[k] for k in fsi.state0},
                    {"psub": cs["psub"], "psup": np.zeros_like(cs["psub"])},
                    {k: prop[k] for k in fsi.prop})
        for _ in range(2):
            forward.integrate_pure(fsi, *fsi_args, times, HEADLINE)
        fsi_entry = graph_entry(fsi, HEADLINE)
        alone = replay_ms(torch, model, HEADLINE, n_steps)
        fsi_alone = replay_ms(torch, fsi, HEADLINE, n_steps)
        prof = profile_run(torch, lambda: graph(times[:PROFILE_STEPS + 1]), PROFILE_STEPS,
                           "newmark_kernel")
        require_traced(prof, used, what)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        graph()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        share = 1 - fsi_alone / alone
        log(f"[fsai] M5 {tag} ({model.solid.ndof} dofs + {len(state0['pinc'])}x2 tract): steps/s"
            f" by CUDA events, in turns " + ", ".join(f"{t['which']} {t['steps_s']:.2f}"
                                                     for t in turns)
            + f"; graph bit-equal to eager, launches {ref['launches']} both ways; integrate:"
            f" lagged_fallback_steps {info_i['lagged_fallback_steps']}, uncertified_steps"
            f" {info_i['uncertified_steps']}; step graph {entry['nodes']} nodes (the uncoupled"
            f" FSI step's {fsi_entry['nodes']}: +{entry['nodes'] - fsi_entry['nodes']} for the"
            f" root solve and the tract), replays alone {alone:.4f} ms a step (FSI"
            f" {fsi_alone:.4f} ms): the root solve and the tract take {share:.1%} of the"
            f" step; profile of {PROFILE_STEPS} graph steps: device busy {prof['busy_ms']:.3f} ms"
            f" of {prof['wall_ms']:.3f} ms, idle share {prof['idle']:.3f},"
            f" {prof['per_step']:.1f} device kernels a step; peak device memory"
            f" {peak / 2**20:.1f} MB over the model's; on {card}")
        out[tag] = dict(launches=turns[1]["launches"], n_steps=n_steps,
                        steps_s=[t["steps_s"] for t in turns], nodes=entry["nodes"],
                        fsi_nodes=fsi_entry["nodes"], replay_ms=alone, fsi_replay_ms=fsi_alone,
                        share=share, idle=prof["idle"], peak=peak)

    # -- 23.7k, production btd against the exact Jacobian ----------------------------------
    used_btd = used + ("btd_sweep",)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        what = f"fsai 23.7k {tag}"
        built = build_fsai(torch, dev, dtype, large=True)
        model, state0, cs, prop = built

        def drive(params):
            return run_timed(torch, model, lambda: forward.integrate_pure(
                model, state0, cs, prop, times, params))

        drive(BTD_PROD)  # warm-up (captures the step)
        (fin, traj, infos), ms, launches, _ = drive(BTD_PROD)
        require_launched(launches, used_btd, what)
        solves = int(infos.num_iter.sum())
        require(launches["btd_sweep"] == 2 * solves,
                f"{what}: {launches['btd_sweep']} K6 launches for {solves} solves")
        (fin_x, _, infos_x), ms_x, _, _ = drive(BTD_EXACT)
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"{what}: non-finite {k}")
        lagged = int((~infos.bracketed).sum()) + int((~infos_x.bracketed).sum())
        err = rel_max(fin["u"].double().cpu().numpy(), fin_x["u"].double().cpu().numpy())
        # the reference's gate, or 1.5x the JAX package's own CPU value of
        # the same runs where that already exceeds it (phase 7's rule)
        jax_err = float(gold["large_traj_err" if tag == "float64" else "large_f32_traj_err"])
        gate = TRAJ_ERR_GATE if jax_err <= TRAJ_ERR_GATE else 1.5 * jax_err
        log(f"[fsai] 23.7k btd prod {tag} ({model.solid.ndof} dofs), {n_steps} steps at dt"
            f" {model.dt:.4e} s: {n_steps / (ms / 1e3):.2f} steps/s (CUDA graph), exact run"
            f" {n_steps / (ms_x / 1e3):.2f}; trajectory error vs the exact-Jacobian run"
            f" {err:.3e} (gate {gate:.3e}; JAX CPU {jax_err:.3e}); lagged steps {lagged};"
            f" launches {launches} ({sum(launches.values()) / n_steps:.1f} a step), on {card}")
        require(lagged == 0, f"{what}: {lagged} steps fell back to the lagged exchange")
        require(err <= gate, f"{what}: trajectory error over its gate")
        out[("23.7k", tag)] = dict(launches=launches, steps_s=n_steps / (ms / 1e3), err=err,
                                   n_steps=n_steps)
        if dtype == torch.float64:
            out["grad 23.7k"] = fsai_grad_large(torch, card, built, times[:FSAI_GRAD_STEPS + 1])
        del built, model, traj

    # -- M5 value+grad ---------------------------------------------------------------------
    built = m5["float64"]
    model, state0, cs, prop = built
    t_grad = times[:FSAI_GRAD_STEPS + 1]
    value_f, ms_f = fsai_value(torch, built, t_grad, ADJ_M5)  # after the M5 runs above
    g = fsai_grad_run(torch, built, t_grad, ADJ_M5)
    value, grads, launches, ms_g, peak = g["value"], g["grads"], g["launches"], g["ms"], g["peak"]
    require(value == value_f, f"fsai grad: value {value!r} != the forward's {value_f!r}")
    require_launched(launches, used + ("newmark_t",), "fsai grad")
    g_area = grads["prop"]["area"]
    require(np.abs(g_area).max() > 0, "fsai grad: the tract area's gradient is zero")
    checks = []
    vals = []
    for h in (1.0, -1.0):
        vals.append(fsai_value(torch, (model, state0, {"psub": cs["psub"] + h}, prop), t_grad,
                               ADJ_M5)[0])
    checks.append(("psub (h = 1 Ba)", float(grads["controls"]["psub"].sum()),
                   (vals[0] - vals[1]) / 2.0))
    d = np.random.default_rng(12).standard_normal(prop["area"].shape)
    vals = []
    for h in (FSAI_AREA_H, -FSAI_AREA_H):
        p = {**prop, "area": prop["area"] + h * d}
        vals.append(fsai_value(torch, (model, state0, cs, p), t_grad, ADJ_M5)[0])
    checks.append((f"the tract areas along a random direction ({FSAI_AREA_H:g} cm^2 a tube)",
                   float(np.dot(g_area, d)), (vals[0] - vals[1]) / (2 * FSAI_AREA_H)))
    log(f"[fsai] M5 value+grad f64 of the RMS radiated pressure over {FSAI_GRAD_STEPS} steps:"
        f" forward {FSAI_GRAD_STEPS / (ms_f / 1e3):.2f} steps/s, value+grad"
        f" {FSAI_GRAD_STEPS / (ms_g / 1e3):.2f} steps/s (CUDA events); J = {value:.9e} (= the"
        f" forward's); peak device memory {peak / 2**20:.1f} MB over the model's; launches"
        f" {launches}, on {card}")
    for what, adj, fd in checks:
        rel = abs(adj - fd) / abs(fd)
        log(f"[fsai] M5 d J / d {what}: adjoint {adj:.9e}, central difference {fd:.9e},"
            f" rel diff {rel:.3e} (rtol {FD_RTOL:.0e})")
        require(fd != 0 and rel <= FD_RTOL, f"fsai grad: {what} off its finite difference")
    out["grad"] = dict(launches=launches, steps_s=FSAI_GRAD_STEPS / (ms_g / 1e3), peak=peak)
    return out


def build_hopf(torch, dev, mesh):
    """The transient and the dynamical model of the Hopf leg on ``mesh``
    (KelvinVoigt + BernoulliSmoothMinSep, ``HOPF_PROPS``, the contact plane
    0.05 and the midline 0.01 above the mesh's top), f64 on the card."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    ymax = mesh.coords[:, 1].max()
    models = []
    for model_type in ("transient", "dynamical"):
        m = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                           model_type=model_type, device=dev, dtype=torch.float64)
        for k, v in dict(HOPF_PROPS, ycontact=ymax + 0.05, ymid=ymax + 0.01).items():
            m.prop[k][:] = v
        models.append(m)
    return models


def hopf_point(torch, tm, dm, psub, **kw):
    """One onset point, ``linear_stability`` at ``psub``: its modes, info and
    equilibrium, its seconds on the host clock, its parts' seconds by CUDA
    events (``dm.hopf_seconds``), its launches and peak memory."""
    import time
    import warnings

    from vf_fem_tpu_torch.misc.hopf import linear_stability

    control = {"psub": np.array([psub]), "psup": np.array([0.0])}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        eigs, eq, info = linear_stability(tm, dm, control, tm.prop, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return dict(eigs=eigs, eq=eq, info=info, s=seconds, parts=dict(dm.hopf_seconds),
                launches=read_launches(),
                peak=torch.cuda.max_memory_allocated() - base,
                warnings=[str(w.message)[:120] for w in caught])


def nearest_mode(lam, ref):
    """Distance of ``lam`` to the nearest of ``ref`` or of their conjugates,
    relative to max(|lam|, 1)."""
    d = np.minimum(np.abs(ref - lam), np.abs(np.conj(ref) - lam))
    return float(d.min() / max(abs(lam), 1.0))


def sweep_512(torch, tm, dm, sigma):
    """K6 at the embedded width of the Hopf point's factors, on the shifted
    pencil at the equilibrium, with the factors the point's solves read
    (f64, and f64 factors stored f32 as ``factor_dtype='float32'`` stores
    them, each with vectors of its dtype): the forward sweep over ``V`` from
    ``g = Sinv r`` and the backward sweep over ``W`` from the plain forward
    sweep's output, each held row by row to the plain version's row
    computed from the kernel's own previous row (rtol 1e-13 / 1e-6 plus the
    dot-product order bound) and as a whole to the plain sweep
    (``SWEEP_FULL_GATES``), as phase 3 holds K6 at the btd path's width.
    The forward sweep's call and device time against its bound (the
    factors read once, the rhs in and the output out, over the HBM
    rate)."""
    from vf_fem_tpu_torch import ops
    from vf_fem_tpu_torch.solvers import cbtd

    plan, K, D, M = dm.solid.assem_banded_state_blocks(tm.solid.bsb_plan())
    sr, si = sigma.real, sigma.imag
    fac = cbtd.cbtd_factor(plan, K + sr * D + (sr * sr - si * si) * M,
                           si * D + 2.0 * sr * si * M)
    del K, D, M
    n, bt, _ = fac.V.shape
    rng = np.random.default_rng(1)
    r = rng.standard_normal((2, plan.ndof))
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        Sinv, V, W = (a.to(dtype) for a in (fac.Sinv, fac.V, fac.W))
        d = fac.d.to(dtype)[: plan.ndof]
        halves = [torch.nn.functional.pad(torch.tensor(h, dtype=dtype, device=V.device) / d,
                                          (0, n * bt // 2 - plan.ndof)).reshape(n, bt // 2)
                  for h in r]
        g = ops.factor_matvec(Sinv, torch.cat(halves, dim=1))
        y = ops.btd_sweep_reference(V, g)
        rtol = 1e-13 if dtype == torch.float64 else 1e-6
        errs = {}
        for label, A, inp, rev in (("forward", V, g, False), ("backward", W, y, True)):
            what = f"hopf K6 {label} at 2Bt = {bt}, {tag}"
            got = ops.btd_sweep(A, inp, reverse=rev)
            torch.cuda.synchronize()
            row_ref, bound = ops.btd_sweep_rows_reference(A, inp, got, rev)
            diff = (got - row_ref).abs()
            off = int((diff > rtol * row_ref.abs() + bound).sum())
            require(off == 0, f"{what}: {off} entries off their rows"
                              f" (max |diff| {diff.max().item():.3e})")
            full = ops.btd_sweep_reference(A, inp, rev)
            err = (got - full).abs().max().item()
            full_rel = err / full.abs().max().item()
            require(full_rel <= SWEEP_FULL_GATES[tag],
                    f"{what}: whole sweep off the plain one ({full_rel:.3e})")
            errs[label] = dict(row=diff.max().item(), err=err, rel=full_rel)
        fn = lambda: ops.btd_sweep(V, g)  # noqa: E731
        nbytes = (n * bt * bt + 2 * n * bt) * V.element_size()
        bound_ms, bound_by = bound_of(nbytes, 2 * n * bt * bt, tag)
        out[tag] = dict(rows=n, bt=bt, ms=cuda_ms(torch, fn, reps=50, warmup=5),
                        device_ms=graph_ms(torch, fn, reps=50), bound_ms=bound_ms,
                        bound_by=bound_by, errs=errs, gate=SWEEP_FULL_GATES[tag], rtol=rtol)
    return out


def phase_hopf(torch, card, dev, m5qz):
    """Phase 14: linear stability.  The Hopf leg at 23.7k (psub 500 then
    1000, f64 factors) against the JAX package's f64 golden, K6 at 2Bt = 512
    timed on the point's factors, the same point with f32 factors against
    the f64 one, and M5 dense QZ (``m5qz``, from ``start_m5_qz``) against
    the banded solver."""
    import time

    from vf_fem_tpu_torch.mesh import load_gmsh
    from vf_fem_tpu_torch.misc.hopf import growth_rate_and_frequency

    golden = np.load(os.path.join(REPO, "tests", "data", "golden_hopf_23k.npz"))
    mesh = load_gmsh(os.path.join(REPO, "meshes", LARGE_MESH))
    tm, dm = build_hopf(torch, dev, mesh)
    nf = dm.fluid.state["q"].numel() + dm.fluid.state["p"].numel()
    out = {}
    for psub in HOPF_PSUBS:
        what = f"hopf 23.7k psub {psub:g} f64"
        r = hopf_point(torch, tm, dm, psub, **HOPF_ARGS)
        eigs, info, tag = r["eigs"], r["info"], f"_{int(psub)}"
        n4, n6 = r["launches"]["bsb_matvec"], r["launches"]["btd_sweep"]
        require(n4 > 0 and n6 > 0, f"{what}: K4 {n4} and K6 {n6} launches")
        require(len(eigs) > 0 and bool(np.all(info["res_rel"] < info["cert_tol"])),
                f"{what}: uncertified modes {info['res_rel']}")
        ref = golden["eigs" + tag]
        dist = [nearest_mode(lam, ref) for lam in eigs]
        g, f = growth_rate_and_frequency(eigs)
        u_err = abs(np.linalg.norm(r["eq"]["u"]) / float(golden["u_norm" + tag]) - 1.0)
        parts = ", ".join(f"{k} {v:.3f}" for k, v in r["parts"].items())
        log(f"[hopf] 23.7k psub {psub:g} f64 ({tm.solid.ndof} dofs, nf {nf}): {r['s']:.3f} s"
            f" a point ({parts} s by CUDA events; W columns {r['parts']['w_columns'] / r['s']:.1%}"
            f" of the point); growth {g:+.6f} 1/s at {f:.6f} Hz (JAX CPU f64"
            f" {float(golden['growth' + tag]):+.6f} at {float(golden['freq' + tag]):.6f});"
            f" {len(eigs)} modes (golden {len(ref)}), farthest from a golden mode"
            f" {max(dist):.3e} (gate {HOPF_GOLDEN_TOL:.0e}); n_conv {info['n_conv']} (golden"
            f" {int(golden['n_conv' + tag])}), res_rel max {info['res_rel'].max():.3e},"
            f" dropped {info['n_cert_dropped']}; |u| vs golden {u_err:.3e}; launches K4 {n4},"
            f" K6 {n6} ({2 * nf} for the W columns), all {r['launches']}; peak device memory"
            f" {r['peak'] / 2**20:.1f} MB; on {card}")
        log(f"[hopf] modes {np.round(eigs, 6).tolist()}")
        require(max(dist) < HOPF_GOLDEN_TOL, f"{what}: modes off the JAX package's golden")
        out[psub] = r
    k6 = sweep_512(torch, tm, dm, complex(HOPF_ARGS["sigma"]))
    for tag, v in k6.items():
        checks = "; ".join(
            f"{k} row max |diff| {e['row']:.3e} (rtol {v['rtol']:.0e} + order bound), whole-sweep"
            f" max_abs_err {e['err']:.3e} (rel {e['rel']:.3e}, gate {v['gate']:.0e})"
            for k, e in v["errs"].items())
        log(f"[hopf] K6 at 2Bt = {v['bt']} ({v['rows']} row blocks), {tag} factors and vectors,"
            f" against the plain sweep: {checks}; forward call {v['ms']:.6f} ms, device"
            f" {v['device_ms']:.6f} ms, bound {v['bound_ms']:.6f} ms ({v['bound_by']}), device at"
            f" {v['bound_ms'] / v['device_ms']:.1%} of it")

    r64 = out[HOPF_PSUBS[0]]
    r32 = hopf_point(torch, tm, dm, HOPF_PSUBS[0], **HOPF_ARGS, factor_dtype="float32")
    e64, e32, i32 = r64["eigs"], r32["eigs"], r32["info"]
    s64, f64_ = growth_rate_and_frequency(e64)
    s32, f32_ = growth_rate_and_frequency(e32)
    scale = abs(e64[0])
    log(f"[hopf] 23.7k psub {HOPF_PSUBS[0]:g} f32 factors (refine {i32['refine']}):"
        f" {r32['s']:.3f} s a point against f64's {r64['s']:.3f} (first point) and"
        f" {out[HOPF_PSUBS[1]]['s']:.3f} (second) ({', '.join(f'{k} {v:.3f}' for k, v in r32['parts'].items())});"
        f" growth {s32:+.6f} (f64 {s64:+.6f}, off {abs(s32 - s64) / scale:.3e} of |lambda_0|,"
        f" gate 1e-05), f {f32_:.6f} Hz (rel {abs(f32_ - f64_) / f64_:.3e}, gate 1e-05);"
        f" res_rel max {i32['res_rel'].max():.3e} (gate 2e-06), min {i32['res_rel'].min():.3e}"
        f" (gate 1e-07); K6 {r32['launches']['btd_sweep']}, K4 {r32['launches']['bsb_matvec']};"
        f" peak {r32['peak'] / 2**20:.1f} MB")
    require(bool(np.all(i32["res_rel"] < 2e-6)), "hopf f32: certificates over 2e-6")
    require(i32["res_rel"].min() < 1e-7, "hopf f32: no certificate under 1e-7")
    require(abs(s32 - s64) < 1e-5 * scale, "hopf f32: growth off the f64 run")
    require(abs(f32_ - f64_) <= 1e-5 * abs(f64_), "hopf f32: frequency off the f64 run")
    out["float32"] = r32
    del tm, dm

    tm, dm, proc = m5qz["tm"], m5qz["dm"], m5qz["proc"]
    t = time.perf_counter()
    qz_out, _ = proc.communicate()
    waited = time.perf_counter() - t
    require(proc.returncode == 0, f"hopf M5: the QZ child exited {proc.returncode}:"
                                  f" {qz_out[-2000:]}")
    with np.load(m5qz["out"]) as qz:
        eigs_d, t_dense = qz["eigs"], float(qz["seconds"])
    sig_d, f_d = growth_rate_and_frequency(eigs_d)
    rb = hopf_point(torch, tm, dm, HOPF_M5_PSUB, solver="banded", sigma=1j * 2 * np.pi * f_d,
                    arnoldi_m=HOPF_M5_M, return_info=True)
    eigs_b, ib = rb["eigs"], rb["info"]
    sig_b, f_b = growth_rate_and_frequency(eigs_b)
    dist = [nearest_mode(lam, eigs_d) for lam in eigs_b[:4]]
    log(f"[hopf] M5 RCM ({tm.solid.ndof} dofs) psub {HOPF_M5_PSUB:g}: dense QZ (Jacobians on"
        f" the card, QZ of {m5qz['n']} x {m5qz['n']} on the host, one thread, in a child"
        f" process beside phases 2-13) {t_dense:.3f} s (this phase waited {waited:.1f} s for"
        f" it), banded (m {HOPF_M5_M}, sigma"
        f" 2 pi {f_d:.3f} i) {rb['s']:.3f} s; growth {sig_b:+.6f} against {sig_d:+.6f}, f"
        f" {f_b:.6f} against {f_d:.6f} Hz; first four banded modes from the dense ones"
        f" {max(dist):.3e} (gate 1e-05); res_rel[:4] max {ib['res_rel'][:4].max():.3e} (gate"
        f" 1e-06); K4 {rb['launches']['bsb_matvec']}, K6 {rb['launches']['btd_sweep']}")
    require(max(dist) < 1e-5, "hopf M5: banded modes off the dense ones")
    require(abs(sig_b - sig_d) <= 1e-5 * abs(sig_d), "hopf M5: growth off the dense one")
    require(abs(f_b - f_d) <= 1e-6 * abs(f_d), "hopf M5: frequency off the dense one")
    require(bool(np.all(ib["res_rel"][:4] < 1e-6)), "hopf M5: certificates over 1e-6")
    out["M5"] = rb
    out["k6_512"] = k6
    return out


def start_m5_qz(torch, dev):
    """Phase 14's M5 dense pencil, built on the card before the timed
    phases (the static solve and the dense Jacobians), and its QZ in a
    child process on the host, one thread, beside phases 2-13 (QZ took
    24-75 s on an H100's host): a dict of the M5 models, the child, its
    output file and the pencil's seconds."""
    import time

    from vf_fem_tpu_torch import cuda_build
    from vf_fem_tpu_torch.mesh import load_gmsh
    from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
    from vf_fem_tpu_torch.misc.hopf import dense_pencil

    t = time.perf_counter()
    m5 = rcm_mesh(load_gmsh(os.path.join(REPO, "meshes", "M5_3layers.msh")))
    tm, dm = build_hopf(torch, dev, m5)
    control = {"psub": np.array([HOPF_M5_PSUB]), "psup": np.array([0.0])}
    A, B, _ = dense_pencil(tm, dm, control, tm.prop)
    pencil_s = time.perf_counter() - t
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pencil = cuda_build.BUILD_DIR / "hopf_m5_pencil.npz"
    out = cuda_build.BUILD_DIR / "hopf_m5_qz.npz"
    np.savez(pencil, A=A, B=B)
    out.unlink(missing_ok=True)
    code = ("import sys, time; import numpy as np;"
            " from vf_fem_tpu_torch.misc.hopf import qz_modes;"
            " p = np.load(sys.argv[1]); t = time.perf_counter(); w = qz_modes(p['A'], p['B']);"
            " np.savez(sys.argv[2], eigs=w, seconds=time.perf_counter() - t)")
    one = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
    proc = subprocess.Popen([sys.executable, "-c", code, str(pencil), str(out)], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, **one})
    log(f"[hopf] M5 RCM ({tm.solid.ndof} dofs) dense pencil {A.shape[0]} x {A.shape[1]} on"
        f" the card in {pencil_s:.1f} s; its QZ runs in a child process beside phases 2-13")
    return dict(tm=tm, dm=dm, proc=proc, out=out, n=A.shape[0])


def start_mesher(name, h, iters, nz=0, zlen=1.5):
    """A cached M5 mesh (phase 13's 94.8k mesh, phase 17's extruded 45.8k
    one), built (or found in its cache) by a child process that runs beside
    the phases: ``(process, start time)``."""
    import time

    proc = subprocess.Popen(
        [sys.executable, "-m", "vf_fem_tpu_torch.mesh.cached", "--name", name, "--h", str(h),
         "--smooth-iters", str(iters), "--extrude", str(nz), "--zlen", str(zlen)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    return proc, time.perf_counter()


def wait_mesher(mesher, what):
    """The child's output once it has finished, and the seconds waited."""
    import time

    proc, _ = mesher
    t0 = time.perf_counter()
    text, _ = proc.communicate(timeout=900)
    require(proc.returncode == 0, f"{what}: the mesher failed: {text}")
    return text, time.perf_counter() - t0


def phase_mesh94k(torch, card, dev, mesher):
    """Phase 13: the 94.8k-dof mesh (its counts), then the production btd
    configuration at refresh 64 on it, f64 and f32, 100 steps, against the
    exact-Jacobian run of each, with steps/s, the launch counts, a step's
    split (one refactorization's time), a profile and the peak memory."""
    import time

    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.mesh.cached import load_cached_m5_mesh

    _, t_start = mesher
    text, waited = wait_mesher(mesher, "mesh94k")
    name, h, iters = MESH94K
    mesh, seconds = load_cached_m5_mesh(name, h, iters)
    require(seconds is None, "mesh94k: the child process left no cache")
    counts = (mesh.num_vertices, mesh.num_cells)
    log(f"[mesh94k] {text.strip()}; the mesher ran beside phases 2-12 (this phase waited"
        f" {waited:.1f} s for it, {time.perf_counter() - t_start:.1f} s after it started):"
        f" {counts[0]} vertices, {counts[1]} cells (expected {MESH94K_COUNTS})")
    require(counts == MESH94K_COUNTS, f"mesh94k: {counts} vertices and cells")
    times = DT * np.arange(N_STEPS + 1)
    used = ("gather", "scatter", "newmark", "btd_sweep")
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        what = f"mesh94k {tag}"
        built = build(torch, dev, mesh, dtype)
        model, state0, cs, prop = built

        def drive(params, ts=times):
            return run_timed(torch, model, lambda: forward.integrate_pure(
                model, state0, cs, prop, ts, params))

        drive(BTD_R64)  # warm-up (captures the step)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (fin, traj, infos), ms, launches, _ = drive(BTD_R64)
        peak = torch.cuda.max_memory_allocated() - base
        require_launched(launches, used, what)
        solves = int(infos.num_iter.sum())
        require(launches["btd_sweep"] == 2 * solves,
                f"{what}: {launches['btd_sweep']} K6 launches for {solves} solves")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"{what}: non-finite {k}")
        # the f64 run against its exact-Jacobian run, the gate; the f32 run
        # has no such gate and runs production alone
        exact = ""
        if dtype == torch.float64:
            (fin_x, _, _), ms_x, _, _ = drive(BTD_EXACT)
            err = rel_max(fin["u"].double().cpu().numpy(), fin_x["u"].double().cpu().numpy())
            exact = (f", exact run {N_STEPS / (ms_x / 1e3):.2f}; trajectory error vs the"
                     f" exact-Jacobian run {err:.3e} (gate {TRAJ_ERR_GATE:.0e}; for scale, TPU:"
                     f" 3.48e-7, STATUS.md:360)")
        mid = {k: v[N_STEPS // 2 - 1] for k, v in traj.items()}
        split, detail = step_split(torch, built, mid, BTD_R64, N_STEPS, ms / N_STEPS)
        prof = profile_run(torch, lambda: forward.integrate_pure(
            model, state0, cs, prop, times[:PROFILE_STEPS + 1], BTD_R64), PROFILE_STEPS,
            "btd_sweep_kernel")
        require_traced(prof, used, what)
        log(f"[mesh94k] btd refresh 64 {tag} ({model.solid.ndof} dofs, {N_STEPS} steps):"
            f" {N_STEPS / (ms / 1e3):.2f} steps/s (CUDA graph, CUDA events){exact}; a graph step"
            f" {ms / N_STEPS:.3f} ms with the two refactorizations amortized ({split['refresh']:.3f}"
            f" ms of it); eager calls at step {N_STEPS // 2}: {detail}; profile of"
            f" {PROFILE_STEPS} steps: device busy"
            f" {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms, idle share"
            f" {prof['idle']:.3f}; peak device memory {peak / 2**20:.1f} MB over the model's;"
            f" launches {launches} ({sum(launches.values()) / N_STEPS:.1f} a step), on {card}")
        if dtype == torch.float64:
            require(err <= TRAJ_ERR_GATE, f"{what}: trajectory error over its gate")
        out[tag] = dict(launches=launches, steps_s=N_STEPS / (ms / 1e3),
                        err=err if dtype == torch.float64 else None,
                        n_steps=N_STEPS, idle=prof["idle"], peak=peak)
        del built, model, traj
    return out


def mesh_digest(mesh):
    """SHA-256 of a mesh's integer data in a form that does not depend on
    the order of its facets and edges: the cells, the cell markers, each
    lower dimension's marked entities (sorted vertex tuples with their
    markers, in lexicographic order) and the subdomains' nonzero markers.
    Either package's ``Mesh`` (numpy arrays); the coords are compared
    apart."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.cells, dtype=np.int64).tobytes())
    for d in range(mesh.dim + 1):
        m = mesh.mesh_functions.get(d)
        if d == mesh.dim:
            rows = np.zeros(len(mesh.cells), np.int64) if m is None else np.asarray(m, np.int64)
        elif m is None:
            rows = np.zeros((0, d + 2), np.int64)
        else:
            m = np.asarray(m, np.int64)
            keep = m != 0
            ents = np.sort(np.asarray(mesh.entities[d], np.int64)[keep], axis=1)
            rows = np.column_stack([ents, m[keep]])
            rows = rows[np.lexsort(rows.T[::-1])]
        h.update(f"{d}:{rows.shape}".encode())
        h.update(np.ascontiguousarray(rows).tobytes())
    names = {int(d): sorted((str(k), int(v)) for k, v in sub.items() if int(v) != 0)
             for d, sub in mesh.subdomains.items()}
    h.update(json.dumps(sorted((d, v) for d, v in names.items() if v)).encode())
    return h.hexdigest()


def extruded_small(torch, dev):
    """``EXTRUDED_SMALL``'s model (f64) on the card: ``(model, state0,
    controls, prop, times)``."""
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.mesh import m5_mesh
    from vf_fem_tpu_torch.mesh.extrude import extrude_mesh
    from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    c = EXTRUDED_SMALL
    zs = np.linspace(0.0, c["zlen"], c["nz"])
    mesh = rcm_mesh(extrude_mesh(m5_mesh(c["profile"], h=c["h"], smooth_iters=c["smooth_iters"]),
                                 zs))
    model = load_fsi_model(mesh, getattr(slr, c["solid"]), getattr(flr, c["fluid"]),
                           coupling="explicit", zs=zs, device=dev, dtype=torch.float64)
    set_values(model, extruded_small_values(mesh.coords[:, 1].max()),
               {"psub": c["psub"], "psup": 0.0})
    state0 = {k: np.zeros_like(v) for k, v in model.state0.items()}
    controls = {k: v[None] for k, v in model.control.items()}
    return model, state0, controls, model.prop, c["dt"] * np.arange(c["n_steps"] + 1)


def ops_3d(torch, model):
    """K3 (nld = 12, the cells and the pressure facets) and K4 (h = 10)
    against their plain versions on the 45.8k fold's Jacobian at rest under
    500 Ba, f64 and f32; K6 at Bt = 1280 on its own factors
    (``sweep_cases``, ``phase_ops_btd``)."""
    from vf_fem_tpu_torch import ops, yardsticks
    from vf_fem_tpu_torch.solvers import bsb

    op = rest_operator(torch, model, 500.0)
    plan, fill = model.solid.bsb_plan()
    blocks64 = bsb.bsb_fill(plan, fill, [op.J_cells, op.J_facets])
    pattern = fill.pattern
    ndof = model.solid.ndof
    log(f"[3d] 45.8k: J_cells {tuple(op.J_cells.shape)}, J_facets {tuple(op.J_facets.shape)},"
        f" blocks {tuple(blocks64.shape)} (nblk {plan.nblk}, nb {plan.nb}, h {plan.h})")
    require(op.J_cells.shape[-1] == 12 and plan.h * plan.b == MESH3D_BT,
            f"3d: nld {op.J_cells.shape[-1]}, Bt {plan.h * plan.b}")
    x_host = np.random.default_rng(0).standard_normal(ndof)
    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        rtol = 1e-13 if dtype == torch.float64 else 1e-6
        es = dtype.itemsize
        x = torch.tensor(x_host, dtype=dtype, device=model.device)
        for label, J, d in (("cells", op.J_cells.to(dtype), op.cell_dofs),
                            ("facets", op.J_facets.to(dtype), op.facet_dofs)):
            ne, nld = J.shape[0], J.shape[-1]
            results[("ebe_matvec", f"45.8k {label}", tag)] = r = check_op(
                torch, f"3d ebe_matvec {label} {tag}",
                lambda: (ops.ebe_matvec(J, x, d),), lambda: (ops.ebe_matvec_reference(J, x, d),),
                lambda: (ops.dot_order_bound(ops.ebe_matvec_reference(J.abs(), x.abs(), d),
                                             nld),),
                rtol, ((J.numel() + x.numel() + ne * nld) * es + d.numel() * 8,
                       2 * J.numel(), tag))
            r["lib_call"] = yardsticks.LIBRARY_CALL["ebe_matvec"]
        blocks = blocks64.to(dtype)
        csr = yardsticks.bsb_csr(plan, blocks, pattern)
        results[("bsb_matvec", "45.8k", tag)] = r = check_op(
            torch, f"3d bsb_matvec {tag}",
            lambda: (ops.bsb_matvec(plan, blocks, x, pattern),),
            lambda: (ops.bsb_matvec_reference(plan, blocks, x),),
            lambda: (ops.dot_order_bound(ops.bsb_matvec_reference(plan, blocks.abs(), x.abs()),
                                         plan.nb * plan.b),),
            rtol, (*bsb_work(pattern, ndof, es), tag),
            lib=lambda: (yardsticks.csr_mm(csr, x).reshape(-1),))
        r["lib_call"] = yardsticks.LIBRARY_CALL["bsb_matvec"]
        del blocks, csr
        for (kname, label, tg), r in results.items():
            if tg == tag:
                log(f"[3d] {kname} {label} {tag}: {fmt_times(r)}; max_abs_err"
                    f" {r['max_abs_err']:.3e}"
                    + ("" if r["lib_err"] is None else f", library max_abs_err {r['lib_err']:.3e}"))
    results.update(phase_ops_btd(torch, sweep_cases(torch, plan, blocks64), line="3d"))
    return results


def phase_3d(torch, card, dev, mesher3d):
    """Phase 17: extruded 3D.  The small extruded stack against its JAX
    golden (``small_3d``); the 45.8k-dof fold's mesh (from its child
    process), K1/K2 on its plan, K3/K4 on its Jacobian and K6 at Bt = 1280
    on its factors against their plain versions (``ops_3d``); its first
    tight f64 btd steps against ``golden_3d_45k.npz``, which also holds the
    JAX package's mesh (``mesh_digest`` and coords) that the port's is held
    to; the production btd settings in f64 and f32 against their
    exact-Jacobian runs (``production_3d``)."""
    from vf_fem_tpu_torch.mesh.cached import load_cached_m5_mesh

    out = {"small": small_3d(torch, card, dev)}
    name, h, iters, nz, zlen = MESH3D
    text, waited = wait_mesher(mesher3d, "3d")
    mesh, _ = load_cached_m5_mesh(name, h, iters, nz=nz, zlen=zlen)
    gold = np.load(os.path.join(REPO, "tests", "data", "golden_3d_45k.npz"))
    digest = mesh_digest(mesh)
    coords_off = (rel_max(mesh.coords, gold["mesh_coords"])
                  if mesh.coords.shape == gold["mesh_coords"].shape else np.inf)
    log(f"[3d] {text.strip()} (a child process beside phases 2-16; this phase waited"
        f" {waited:.1f} s); against the JAX package's mesher (golden_3d_45k.npz): mesh_digest"
        f" {'equal' if digest == str(gold['mesh_digest']) else 'DIFFERENT'}, coords"
        f" {coords_off:.3e} of their largest (gate {MESH3D_COORDS_RTOL:.0e})")
    require(digest == str(gold["mesh_digest"]) and coords_off <= MESH3D_COORDS_RTOL,
            "3d: the port's mesh is not the JAX package's")
    out["kernels"] = {}
    banded_contracts(torch, dev, "45.8k", mesh, out["kernels"], "3d")
    big = build_3d(torch, dev, mesh, torch.float64)
    out["ops"] = ops_3d(torch, big[0])
    golden_3d(torch, big)
    out.update(production_3d(torch, card, dev, mesh, big))
    return out


def small_3d(torch, card, dev):
    """The small extruded stack's dense exact and btd runs (f64 and bf16
    factors) against the JAX golden and each other; the launches of each."""
    from vf_fem_tpu_torch import forward

    out = {}
    gold = np.load(os.path.join(REPO, "tests", "data", "golden_3d.npz"))
    model, state0, cs, prop, times = extruded_small(torch, dev)
    n_small = len(times) - 1
    u = {}
    for run, params in EXTRUDED_SMALL_RUNS.items():
        (fin, traj, infos), ms, launches, _ = run_timed(torch, model, lambda: (
            forward.integrate_pure(model, state0, cs, prop, times, params)))
        used = ("newmark",) + (("gather", "scatter", "btd_sweep") if run != "dense" else ())
        require_launched(launches, used, f"3d small {run}")
        u[run] = traj["u"].cpu().numpy()
        errs = {k: rel_max(traj[k].cpu().numpy(), gold[f"btd3d|{run}|{k}"]) for k in ("u", "q")}
        log(f"[3d] small extruded M5_CB_GA3 ({model.solid.ndof} dofs, {len(model.fluid.state0['q'])}"
            f" channels) {run}, {n_small} steps: vs the JAX golden max|du|/max|u|"
            f" {errs['u']:.3e}, q {errs['q']:.3e} (gate {GOLDEN_3D_RTOL:.0e});"
            f" {n_small / (ms / 1e3):.2f} steps/s; launches {launches}, on {card}")
        require(max(errs.values()) <= GOLDEN_3D_RTOL, f"3d small {run}: off the golden")
        out[run] = dict(launches=launches, n_steps=n_small)
    btd_vs_dense = rel_max(u["btd"], u["dense"])
    bf16_vs_dense = rel_max(u["btd16"], u["dense"])
    log(f"[3d] small: btd f64 vs dense exact {btd_vs_dense:.3e}, bf16 factors vs dense"
        f" {bf16_vs_dense:.3e} (gate {EXTRUDED_BF16_VS_DENSE:.0e})")
    require(np.allclose(u["btd"], u["dense"], rtol=1e-7, atol=1e-11)
            and bf16_vs_dense < EXTRUDED_BF16_VS_DENSE, "3d small: btd off the dense run")
    return out


def build_3d(torch, dev, mesh, dtype):
    """The 45.8k fold (``build`` on the extruded mesh, a fluid channel a
    z-plane), its size checked."""
    from vf_fem_tpu_torch.mesh.cached import extrusion_planes

    counts = (mesh.num_vertices, mesh.num_cells)
    require(mesh.dim == 3 and counts == MESH3D_COUNTS,
            f"3d: mesh of {counts} vertices and tetrahedra (expected {MESH3D_COUNTS})")
    return build(torch, dev, mesh, dtype, zs=extrusion_planes(*MESH3D[3:]))


def golden_3d(torch, big):
    """The first ``GOLDEN_3D_STEPS`` tight f64 btd steps against the JAX
    package's (every eighth u entry and q)."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_3d_45k.npz"))
    every = int(gold["every"])
    model, state0, cs, prop = big
    (fin, traj, infos), ms, launches, _ = run_timed(torch, model, lambda: forward.integrate_pure(
        model, state0, cs, prop, DT * np.arange(GOLDEN_3D_STEPS + 1), BTD_TIGHT))
    errs = {"u": rel_max(traj["u"].cpu().numpy()[:, ::every], gold["u"]),
            "q": rel_max(traj["q"].cpu().numpy(), gold["q"])}
    log(f"[3d] 45.8k ({model.solid.ndof} dofs, {len(model.fluid.state0['q'])} channels) tight"
        f" f64 btd, {GOLDEN_3D_STEPS} steps, vs golden_3d_45k.npz (JAX CPU): max|du|/max|u|"
        f" {errs['u']:.3e}, q {errs['q']:.3e} (gate {GOLDEN_3D_RTOL:.0e}); Newton"
        f" {infos.num_iter.tolist()} (golden {gold['num_iter'].tolist()}); launches {launches}")
    require(max(errs.values()) <= GOLDEN_3D_RTOL, "3d: tight run off the golden")


def production_3d(torch, card, dev, mesh, big):
    """The production btd settings on the 45.8k fold, f64 (``big``) then
    f32: 100 steps, a replay of the captured step a step (f64: bit-equal to
    the eager loop), against the exact-Jacobian run (``TRAJ_ERR_GATE``, or
    1.5x the JAX package's CPU value in ``golden_3d_45k.npz`` where that
    exceeds it), with steps/s, launches a step, graph nodes, one
    refactorization's ms, the peak device memory and a profile of the f64
    run."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_3d_45k.npz"))
    jax_errs = {"float64": float(gold["traj_err"]), "float32": float(gold["f32_traj_err"])}
    out = {}
    used = ("gather", "scatter", "newmark", "btd_sweep")
    times = DT * np.arange(N_STEPS + 1)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        jax_err = jax_errs[tag]
        what = f"3d 45.8k {tag}"
        if dtype == torch.float32:
            big = build_3d(torch, dev, mesh, dtype)
        model, state0, cs, prop = big

        def drive(params, ts=times):
            return run_timed(torch, model, lambda: forward.integrate_pure(
                model, state0, cs, prop, ts, params))

        drive(BTD_PROD)  # warm-up (captures the step)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, ms, launches, _ = drive(BTD_PROD)
        peak = torch.cuda.max_memory_allocated() - base
        fin, traj, infos = res
        require_launched(launches, used, what)
        solves = int(infos.num_iter.sum())
        require(launches["btd_sweep"] == 2 * solves,
                f"{what}: {launches['btd_sweep']} K6 launches for {solves} solves")
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"{what}: non-finite {k}")
        entry = graph_entry(model, BTD_PROD)
        alone = replay_ms(torch, model, BTD_PROD, N_STEPS)
        eager = ""
        if dtype == torch.float64:
            res_e, ms_e, launches_e, _ = run_timed(torch, model, lambda: forward._integrate_eager(
                model, state0, cs, prop, times, BTD_PROD))
            require(same_run(torch, res, res_e) and launches_e == launches,
                    f"{what}: the graph run is not bit-equal to the eager loop")
            eager = (f"; bit-equal to the eager loop ({N_STEPS / (ms_e / 1e3):.2f} steps/s,"
                     f" the same launches)")
            del res_e
        (fin_x, _, _), ms_x, _, _ = drive(BTD_EXACT)
        err = rel_max(fin["u"].double().cpu().numpy(), fin_x["u"].double().cpu().numpy())
        gate = TRAJ_ERR_GATE if jax_err <= TRAJ_ERR_GATE else 1.5 * jax_err
        mid = {k: v[N_STEPS // 2 - 1] for k, v in traj.items()}
        split, detail = step_split(torch, big, mid, BTD_PROD, N_STEPS, ms / N_STEPS)
        prof = ""
        if dtype == torch.float64:
            p = profile_run(torch, lambda: forward.integrate_pure(
                model, state0, cs, prop, times[:PROFILE_STEPS + 1], BTD_PROD), PROFILE_STEPS,
                "btd_sweep_kernel")
            require_traced(p, used, what)
            prof = (f"; profile of {PROFILE_STEPS} steps: device busy {p['busy_ms']:.3f} ms of"
                    f" {p['wall_ms']:.3f} ms, idle share {p['idle']:.3f}, K6 {p['k_ms']:.3f} ms"
                    f" ({p['k_ms'] / p['busy_ms']:.1%} of busy) in {p['k_launches']} launches")
            out["profile"] = {k: v for k, v in p.items() if k != "table"}
            log(p["table"])
        per_step = {k: launches[k] / N_STEPS for k in used}
        log(f"[3d] 45.8k production btd {tag} ({model.solid.ndof} dofs, {N_STEPS} steps):"
            f" {N_STEPS / (ms / 1e3):.2f} steps/s (CUDA graph, CUDA events){eager}; exact run"
            f" {N_STEPS / (ms_x / 1e3):.2f}; trajectory error vs the exact-Jacobian run"
            f" {err:.3e} (gate {gate:.1e}; JAX CPU {jax_err:.3e}); graph {entry['nodes']} nodes"
            f" a step, the replays alone {alone:.4f} ms a step; launches a step {per_step}; a graph"
            f" step {ms / N_STEPS:.3f} ms with the two refactorizations amortized"
            f" ({split['refresh']:.3f} ms of it); eager calls at step"
            f" {N_STEPS // 2}: {detail}; peak device memory {peak / 2**20:.1f} MB over the"
            f" model's{prof}; on {card}")
        require(err <= gate, f"{what}: trajectory error over its gate")
        out[tag] = dict(launches=launches, steps_s=N_STEPS / (ms / 1e3), err=err, gate=gate,
                        n_steps=N_STEPS, peak=peak, nodes=entry["nodes"], split=split,
                        replay_ms=alone)
        del big, model, traj, res
    return out


# phase 18, SPIKE and the DOF-sharded step: K6 over slabs on the 23.7k
# model's own SPIKE factors (at rest under 500 Ba, r / d of a seeded r) at
# DD_SHARDS slabs in the three dtype pairs of the path and at SLAB_WAVES
# (f64: 16 slabs of 16-CTA clusters run in waves); K1/K2 on the stacked
# per-shard plans of the 23.7k DD_SHARDS partition; bench.py:411-434 with
# linear_solver='spike' (spike_partitions 8) in f64 in the step graph and
# eagerly, against phase 7's exact-Jacobian btd run (TRAJ_ERR_GATE); the
# DD step (assembly 'banded' and 'plain', f64 factors, refresh 8, adaptive
# Newton, DD_STEPS steps) against the single-device run with factors at
# each step's predictor (tests/test_ddstep.py:85-120's gates: max|du| <
# DD_U_GATE max|u|, q at rtol DD_Q_RTOL; 'banded' within DD_ASM_GATE of
# 'plain', :499-536)
SPIKE_PROD = {**BTD_PROD, "linear_solver": "spike", "spike_partitions": 8}
DD_SHARDS = 8
SLAB_WAVES = (4, 16)
DD_STEPS = 20
DD_PARAMS = {"assembly": "banded", "jacobian_refresh_steps": 8}
DD_REF = {"assembly": "banded", "linear_solver": "btd", "jacobian_refresh_steps": 1}
DD_U_GATE, DD_Q_RTOL, DD_ASM_GATE = 1e-10, 1e-9, 1e-9


def slab_cases(torch, plan, blocks64):
    """K6-over-slabs inputs on the model's own SPIKE factors: ``(S, ftag,
    vdt, factors, g)`` with ``g = Sinv r`` of a seeded r / d in slabs."""
    from vf_fem_tpu_torch import ops
    from vf_fem_tpu_torch.solvers import spike

    r = np.random.default_rng(2).standard_normal(plan.ndof)
    out = []
    for S, pairs in ((DD_SHARDS, (("bfloat16", torch.float64), ("float64", torch.float64),
                                  ("float32", torch.float32))),
                     *((s, (("float64", torch.float64),)) for s in SLAB_WAVES)):
        for ftag, vdt in pairs:
            fac = spike.spike_factor(plan, blocks64.float() if ftag == "float32" else blocks64, S,
                                     store_dtype="bfloat16" if ftag == "bfloat16" else None)
            _, m, bt, _ = fac.Sinv.shape
            d = fac.d.to(vdt)[: plan.ndof]
            rb = torch.nn.functional.pad(torch.tensor(r, dtype=vdt, device=blocks64.device) / d,
                                         (0, S * m * bt - plan.ndof)).reshape(S, m, bt)
            out.append((S, ftag, vdt, fac, ops.factor_matvec(fac.Sinv, rb)))
    return out


def dd_sweeps(torch, cases, card):
    """K6 over slabs against its plain version: each slab's forward sweep
    over P and backward sweep over Q held row by row (the plain row from the
    kernel's own previous row, rtol 1e-13 / 1e-6 plus the dot-product order
    bound) and as a whole (``SWEEP_FULL_GATES``), and bit for bit against
    one launch of K6 a slab; timed with S separate launches beside it."""
    from vf_fem_tpu_torch import ops, yardsticks

    results = {}
    for S, ftag, vdt, fac, g in cases:
        vtag = str(vdt).replace("torch.", "")
        rtol, acc = sweep_tolerances(torch, ftag, vdt)
        y = ops.btd_sweep_slabs_reference(fac.P, g)
        for label, A, inp, rev in (("forward", fac.P, g, False), ("backward", fac.Q, y, True)):
            what = f"dd btd_sweep over {S} slabs {label} {ftag}/{vtag}"
            out = ops.btd_sweep(A, inp, reverse=rev)
            alone = torch.stack([ops.btd_sweep(A[s], inp[s], reverse=rev) for s in range(S)])
            torch.cuda.synchronize()
            require(torch.equal(out, alone), f"{what}: not bit-equal to a launch a slab")
            worst = 0.0
            for s in range(S):
                row_ref, bound = ops.btd_sweep_rows_reference(A[s], inp[s], out[s], rev)
                diff = (out[s] - row_ref).abs()
                worst = max(worst, diff.max().item())
                off = int((diff > rtol * row_ref.abs() + bound).sum())
                require(off == 0, f"{what}: slab {s}, {off} entries off their rows")
            full = ops.btd_sweep_slabs_reference(A, inp, rev)
            err = (out - full).abs().max().item()
            full_rel = err / full.abs().max().item()
            require(full_rel <= SWEEP_FULL_GATES[acc], f"{what}: whole sweep off ({full_rel:.3e})")
            res = measure(torch, lambda: ops.btd_sweep(A, inp, reverse=rev),
                          lambda: ops.btd_sweep_slabs_reference(A, inp, rev))
            sep_ms = cuda_ms(torch, lambda: [ops.btd_sweep(A[s], inp[s], reverse=rev)
                                             for s in range(S)])
            sep_dev = graph_ms(torch, lambda: [ops.btd_sweep(A[s], inp[s], reverse=rev)
                                               for s in range(S)], reps=20)
            nbytes = A.numel() * A.element_size() + 2 * inp.numel() * inp.element_size()
            res.update(max_abs_err=err, bytes=nbytes, lib_ms=None, lib_runs=None,
                       lib_call=yardsticks.LIBRARY_CALL["btd_sweep_slabs"],
                       separate_ms=sep_ms, separate_device_ms=sep_dev)
            res["bound_ms"], res["bound_by"] = bound_of(nbytes, 2 * A.numel(), acc)
            _, m, bt, _ = A.shape
            log(f"[dd] btd_sweep over {S} slabs {label} {ftag}/{vtag} ({S} x {m} x {bt} x {bt}):"
                f" {fmt_times(res)}; {S} launches of one slab: call {sep_ms:.6f} ms, device"
                f" {sep_dev:.6f} ms; bit-equal to them; row max |diff| {worst:.3e}, whole-sweep"
                f" max_abs_err {err:.3e} (rel {full_rel:.3e}); on {card}")
            results[(S, label, ftag, vtag)] = res
    return results


def dd_channels(model):
    """The channels ``DDIntegrator``'s banded cell pass gathers: u1, u, v,
    a, the cg1 coefficients, the coordinates."""
    spec = model.solid.residual.coefficient_spec
    dim = model.solid.dim
    return 5 * dim + sum(dim if s.space == "cg1_vector" else 1 for k, s in spec.items()
                         if s.space in ("cg1_vector", "cg1_scalar")
                         and not k.startswith("state/") and k != "control/tcontact")


def dd_banded(torch, integ, card):
    """K1/K2 on the stacked per-shard plans of the 23.7k partition and
    their VJPs (each the other) against the plain versions, f64 and f32, at
    the DD cell pass's channel counts, with their library calls (one
    ``index_select``, one block-diagonal ``sparse.mm``)."""
    from vf_fem_tpu_torch import yardsticks
    from vf_fem_tpu_torch.fem import banded

    dp, p = integ.dplan, integ.plan
    S, nvh, dim = p.S, integ._nvert_halo, p.dim
    ng = dd_channels(integ.model)
    log(f"[dd] stacked plan: {S} shards, ngroups={dp.ngroups} gc={dp.gc} w={dp.w}"
        f" nvert_pad={dp.nvert_pad}, {nvh} vertices a shard with the halo; {ng} channels"
        f" gathered, {dim} scattered")
    rng = np.random.default_rng(3)
    host = dict(F=rng.standard_normal((S, ng, nvh)), loc=rng.standard_normal((S, dp.nv, dim, dp.ncpad)),
                ct_loc=rng.standard_normal((S, dp.nv, ng, dp.ncpad)),
                ct_rows=rng.standard_normal((S, dim, nvh)))
    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        t = {k: torch.tensor(v, dtype=dtype, device=dp.base.device) for k, v in host.items()}
        rtol = 1e-13 if dtype == torch.float64 else 1e-6
        F = t["F"].clone().requires_grad_()
        loc = t["loc"].clone().requires_grad_()
        g_out = banded.banded_gather_t(dp, F)
        s_out = banded.banded_scatter_t(dp, loc, nvh)
        (gF,) = torch.autograd.grad(g_out, F, t["ct_loc"])
        (gloc,) = torch.autograd.grad(s_out, loc, t["ct_rows"])
        checks = {
            "gather_t": (g_out, banded.banded_gather_t_reference(dp, t["F"], dp.g), None),
            "scatter_t": (s_out, banded.banded_scatter_t_reference(dp, t["loc"], nvh, dp.s),
                          banded.scatter_order_bound(dp, t["loc"], nvh, dp.s)),
            "gather_t_vjp": (gF, banded.banded_scatter_t_reference(dp, t["ct_loc"], nvh, dp.g),
                             banded.scatter_order_bound(dp, t["ct_loc"], nvh, dp.g)),
            "scatter_t_vjp": (gloc, banded.banded_gather_t_reference(dp, t["ct_rows"], dp.s), None),
        }
        torch.cuda.synchronize()
        errs = {}
        for op, (out, ref, bnd) in checks.items():
            diff = (out - ref).abs()
            errs[op] = diff.max().item()
            if bnd is None:
                require(errs[op] == 0.0, f"dd {tag} {op}: not exact ({errs[op]:.3e})")
            else:
                off = int((diff > rtol * ref.abs() + bnd).sum())
                require(off == 0, f"dd {tag} {op}: {off} entries off (max {errs[op]:.3e})")
        F0, loc0 = t["F"], t["loc"]
        idx, ok = yardsticks.gather_flat_index_t(dp, dp.g, ng, nvh)
        require(bool(ok.all()), "dd: gather offsets with padding slots")
        M = yardsticks.scatter_csr_t(dp, dp.s, dim, nvh, dtype)
        lib_g = yardsticks.gather_index_select(F0, idx).reshape(g_out.shape)
        lib_s = yardsticks.csr_mm(M, loc0).reshape(s_out.shape)
        lib_err = {"gather_t": (lib_g - checks["gather_t"][1]).abs().max().item(),
                   "scatter_t": (lib_s - checks["scatter_t"][1]).abs().max().item()}
        require(lib_err["gather_t"] == 0.0, f"dd {tag}: index_select not exact")
        off = int(((lib_s - checks["scatter_t"][1]).abs()
                   > rtol * checks["scatter_t"][1].abs() + checks["scatter_t"][2]).sum())
        require(off == 0, f"dd {tag}: sparse.mm scatter off ({off} entries)")
        times = {
            "gather_t": measure(torch, lambda: banded.banded_gather_t(dp, F0),
                                lambda: banded.banded_gather_t_reference(dp, F0, dp.g),
                                lambda: yardsticks.gather_index_select(F0, idx)),
            "scatter_t": measure(torch, lambda: banded.banded_scatter_t(dp, loc0, nvh),
                                 lambda: banded.banded_scatter_t_reference(dp, loc0, nvh, dp.s),
                                 lambda: yardsticks.csr_mm(M, loc0)),
        }
        es = F0.element_size()
        nnz = sum(int(dp.s.ptr[s, nvh] - dp.s.ptr[s, 0]) for s in range(S))
        nbytes = {
            "gather_t": S * ((dp.nv * ng * dp.ncpad + ng * nvh) * es
                             + (dp.ngroups * dp.nv * dp.gc + dp.ngroups) * 4),
            "scatter_t": S * ((dp.nv * dim * dp.ncpad + dim * nvh) * es + (nvh + 1) * 4)
                         + nnz * 4,
        }
        for op in ("gather_t", "scatter_t"):
            r = times[op]
            r.update(max_abs_err=errs[op], bytes=nbytes[op], lib_err=lib_err[op],
                     lib_call=yardsticks.LIBRARY_CALL[op])
            r["bound_ms"], r["bound_by"] = bound_of(nbytes[op], 0, tag)
            log(f"[dd] banded_{op} 23.7k x {S} shards {tag}: {fmt_times(r)}; max_abs_err"
                f" {errs[op]:.3e} (vjp {errs[op + '_vjp']:.3e}), library max_abs_err"
                f" {lib_err[op]:.3e}; on {card}")
            results[(tag, op)] = r
    return results


def dd_spike(torch, card, large, btd_res, integ):
    """Single-device ``linear_solver='spike'`` at 23.7k on the production
    settings (``SPIKE_PROD``, f64): eager, graph, graph, each graph run bit
    for bit the eager one with equal launches; two K6-over-slabs launches a
    solve and no K6 of one slab; the final u against phase 7's
    exact-Jacobian btd run."""
    from vf_fem_tpu_torch import forward

    gold = np.load(os.path.join(REPO, "tests", "data", "golden_large_btd_explicit.npz"))
    times = gold["times"]
    n_steps = len(times) - 1
    model, state0, cs, prop = large["float64"]
    forward.integrate_pure(model, state0, cs, prop, times[:3], SPIKE_PROD)  # warm-up, capture
    turns = []
    for which in ("eager", "graph", "graph"):
        fn = forward._integrate_eager if which == "eager" else forward.integrate_pure
        res, ms, launches, _ = run_timed(torch, model, lambda: fn(model, state0, cs, prop, times,
                                                                     SPIKE_PROD))
        turns.append(dict(which=which, res=res, ms=ms, launches=launches,
                          steps_s=n_steps / (ms / 1e3)))
    ref = turns[0]
    for t in turns[1:]:
        require(same_run(torch, t["res"], ref["res"]), f"spike: a {t['which']} run is not"
                                                       " bit-equal to the eager run")
        require(t["launches"] == ref["launches"], f"spike: launches {t['launches']} !="
                                                   f" {ref['launches']}")
    fin, traj, infos = ref["res"]
    launches = ref["launches"]
    solves = int(infos.num_iter.sum())
    require_launched(launches, ("gather", "scatter", "newmark", "btd_sweep_slabs"), "spike")
    require(launches["btd_sweep_slabs"] == 2 * solves and launches["btd_sweep"] == 0,
            f"spike: K6 launches {launches['btd_sweep_slabs']} over slabs,"
            f" {launches['btd_sweep']} of one slab, for {solves} solves")
    for k, v in traj.items():
        require(bool(torch.isfinite(v).all()), f"spike: non-finite {k}")
    err = rel_max(fin["u"].double().cpu().numpy(), btd_res["float64"]["exact_u"])
    gate = btd_res["float64"]["gate"]
    btd_graph = [t["steps_s"] for t in integ[("23.7k btd", "float64")]["turns"]
                 if t["which"] == "graph"]
    entry = graph_entry(model, SPIKE_PROD)
    log(f"[dd] spike prod f64 (8 partitions): steps/s by CUDA events "
        + ", ".join(f"{t['which']} {t['steps_s']:.2f}" for t in turns)
        + f" (phase 8's btd graph: {', '.join(f'{x:.2f}' for x in btd_graph)}); graph bit-equal"
        f" to eager; {entry['nodes']} graph nodes a step; K6 over slabs"
        f" {launches['btd_sweep_slabs'] / n_steps:.1f} launches a step; trajectory error vs the"
        f" exact-Jacobian btd run {err:.3e} (gate {gate:.1e}); launches {launches}; on {card}")
    require(err <= gate, "spike prod: trajectory error over its gate")
    return dict(launches=launches, n_steps=n_steps, traj_err=err,
                steps_s=[t["steps_s"] for t in turns])


def dd_step(torch, card, large):
    """The DOF-sharded step at 23.7k over ``DD_SHARDS`` shards stacked on
    the card (``parallel.ddstep.DDIntegrator``): 'banded' (K1/K2 on the
    stacked plans) and 'plain' against each other and against the
    single-device run, with steps/s, peak memory and launches a step."""
    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.parallel import ddstep

    model, state0, cs, prop = large["float64"]
    times = DT * np.arange(DD_STEPS + 1)
    (fin_r, traj_r, infos_r), ms_r, _, _ = run_timed(
        torch, model, lambda: forward.integrate_pure(model, state0, cs, prop, times, DD_REF))
    out = {}
    for asm in ("banded", "plain"):
        integ = ddstep.DDIntegrator(model, DD_SHARDS, {**DD_PARAMS, "assembly": asm})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (fin, traj, infos), ms, launches, _ = run_timed(
            torch, model, lambda: integ.integrate_pure(state0, cs, prop, times))
        peak = torch.cuda.max_memory_allocated() - base
        for k, v in traj.items():
            require(bool(torch.isfinite(v).all()), f"dd {asm}: non-finite {k}")
        u, ur = traj["u"].cpu().numpy(), traj_r["u"].cpu().numpy()
        du = float(np.abs(u - ur).max() / np.abs(ur).max())
        q, qr = traj["q"].cpu().numpy(), traj_r["q"].cpu().numpy()
        q_ok = bool(np.all(np.abs(q - qr) <= 1e-12 + DD_Q_RTOL * np.abs(qr)))
        solves = int(infos.num_iter.sum())
        per_step = {k: v / DD_STEPS for k, v in launches.items() if v}
        log(f"[dd] DD {DD_SHARDS} shards, assembly {asm}, 23.7k f64, {DD_STEPS} steps:"
            f" {DD_STEPS / (ms / 1e3):.2f} steps/s (single device, factors every step:"
            f" {DD_STEPS / (ms_r / 1e3):.2f}); max|du|/max|u| vs the single-device run {du:.3e}"
            f" (gate {DD_U_GATE:.0e}), q within rtol {DD_Q_RTOL:.0e}: {q_ok}; Newton"
            f" {infos.num_iter.tolist()} ({solves} solves; single device"
            f" {infos_r.num_iter.tolist()}); peak device memory {peak / 2**20:.1f} MB; launches a"
            f" step {per_step}; on {card}")
        require(du < DD_U_GATE, f"dd {asm}: trajectory off the single-device run ({du:.3e})")
        require(q_ok, f"dd {asm}: q off the single-device run")
        if asm == "banded":
            require_launched(launches, ("gather_t", "scatter_t", "btd_sweep_slabs"), "dd banded")
            require(launches["btd_sweep_slabs"] == 2 * solves,
                    f"dd: {launches['btd_sweep_slabs']} K6 launches for {solves} solves")
            out["integ"] = integ
        out[asm] = dict(u=u, launches=launches, steps_s=DD_STEPS / (ms / 1e3), peak=peak,
                        n_steps=DD_STEPS, err=du)
    d_asm = float(np.abs(out["banded"]["u"] - out["plain"]["u"]).max()
                  / np.abs(out["plain"]["u"]).max())
    log(f"[dd] DD banded vs plain: max|du|/max|u| {d_asm:.3e} (gate {DD_ASM_GATE:.0e})")
    require(d_asm < DD_ASM_GATE, "dd: banded assembly off the plain one")
    return out


def phase_dd(torch, card, large, btd_res, integ):
    """Phase 18 (see the constants above)."""
    from vf_fem_tpu_torch.solvers import bsb

    model = large["float64"][0]
    plan, fill = model.solid.bsb_plan()
    op = rest_operator(torch, model, 500.0)
    blocks = bsb.bsb_fill(plan, fill, [op.J_cells, op.J_facets])
    sweeps = dd_sweeps(torch, slab_cases(torch, plan, blocks), card)
    spk = dd_spike(torch, card, large, btd_res, integ)
    step = dd_step(torch, card, large)
    kern = dd_banded(torch, step["integ"], card)
    return dict(sweeps=sweeps, spike=spk, step=step, banded=kern)


def sweep_props(model, batch):
    """bench.py:628-655: ``batch`` variants of the model's properties, emod
    4e4 .. 6e4 and the umesh bump scaled -1 .. 1."""
    X = model.solid.residual.mesh().coords
    bump = np.zeros_like(X)
    bump[:, 1] = (0.004 * np.sin(np.pi * (X[:, 0] - X[:, 0].min()) / max(np.ptp(X[:, 0]), 1e-9))
                  * (X[:, 1] - X[:, 1].min()) / max(np.ptp(X[:, 1]), 1e-9))
    pb = {k: np.broadcast_to(v, (batch,) + v.shape).copy() for k, v in model.prop.items()}
    pb["emod"] = np.broadcast_to(np.linspace(4e4, 6e4, batch)[:, None],
                                 (batch,) + model.prop["emod"].shape).copy()
    pb["umesh"] = np.linspace(-1.0, 1.0, batch)[:, None] * bump.reshape(-1)[None, :]
    return pb


def sweep_close(got, ref, gap):
    """A row against its variant run alone, as tests/test_parallel.py:59-62
    holds u: u within SWEEP_ALONE_RTOL and SWEEP_ALONE_ATOL, q and p at
    that rtol with the atol of the field's scale, max(1, max|ref|); v and a,
    which carry u's rounding gap scaled by 2/dt and 4/dt^2 and their own
    rounding through the undamped Newmark recurrence, within
    SWEEP_ALONE_VA of their max once ``gap`` (``tests/port_fixtures.
    newmark_gap`` of the gaps in u over the run) is taken out.  Returns
    each field's max|diff| / max|ref| (v and a: before and after the gap)."""
    out = {}
    for k, r in ref.items():
        g, r = np.asarray(got[k]), np.asarray(r)
        rel = float(np.abs(g - r).max() / np.abs(r).max())
        if k in gap:
            g = g - gap[k][-1]
            out[k] = (rel, float(np.abs(g - r).max() / np.abs(r).max()))
            ok = out[k][1] <= SWEEP_ALONE_VA
        else:
            out[k] = rel
            atol = SWEEP_ALONE_ATOL * (1.0 if k == "u" else max(1.0, float(np.abs(r).max())))
            ok = np.allclose(g, r, rtol=SWEEP_ALONE_RTOL, atol=atol)
        require(ok, f"sweep: {k} off its variant's run alone ({np.abs(g - r).max():.3e})")
    return out


def sweep_leg(torch, card, built, batch, n_steps, assembly, profile=True):
    """One batched sweep run of ``batch`` variants x ``n_steps`` steps in
    ``assembly``: a short graph run that captures the batched step (and
    warms up), the batched eager loop, then the graph run, bit-equal to the
    eager loop; variant-steps/s of each, the graph run's peak memory,
    launches a step, the replay alone, and (with ``profile``) the idle
    share of a profiled graph run of its first SWEEP_PROFILE_STEPS steps."""
    from vf_fem_tpu_torch import forward, step_graph
    from vf_fem_tpu_torch.models.transient import solver_params

    model, state0, cs, _ = built
    pb = sweep_props(model, batch)
    params = solver_params({**SWEEP_PARAMS, "assembly": assembly})
    times = DT * np.arange(n_steps + 1)
    batch_key = (batch, False)

    def graph_run(steps=n_steps):
        return forward.integrate_batch_pure(model, state0, cs, pb, times[:steps + 1], params)

    run_timed(torch, model, lambda: graph_run(3))  # captures the batched step, and warms up
    eager, e_ms, e_launch, _ = run_timed(torch, model, lambda: forward._integrate_eager(
        model, state0, cs, pb, times, params, batch_key))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    graph, g_ms, g_launch, _ = run_timed(torch, model, graph_run)
    peak = torch.cuda.max_memory_allocated() - base
    eager = (eager[0], {k: v.movedim(0, 1) for k, v in eager[1].items()},
             type(eager[2])(*(x.movedim(0, 1) for x in eager[2])))
    require(same_run(torch, graph, eager), f"sweep {batch} {assembly}: the graph run differs"
            " from the batched eager loop")
    fin = {k: v.cpu().numpy() for k, v in graph[0].items()}
    for k, v in fin.items():
        require(bool(np.isfinite(v).all()), f"sweep {batch} {assembly}: non-finite {k}")
    u = fin["u"]
    require(len({u[b].tobytes() for b in range(batch)}) == batch,
            f"sweep {batch} {assembly}: rows not distinct")
    per_step = {k: v / n_steps for k, v in g_launch.items() if v}
    require(g_launch["newmark"] == n_steps,
            f"sweep {batch} {assembly}: {g_launch['newmark']} K5 launches in {n_steps} steps")
    if assembly == "banded":
        require_launched(g_launch, ("gather", "scatter", "newmark"), f"sweep {batch} banded")
    stats = model._step_graphs[step_graph.cache_key(params, batch_key)].stats
    replay = replay_ms(torch, model, params, n_steps, batch_key)
    out = dict(fin=fin, pb=pb, params=params, times=times, launches=g_launch,
               traj_u=graph[1]["u"].cpu().numpy(),
               eager_launches=e_launch, per_step=per_step, peak=peak,
               graph_vs=batch * n_steps / (g_ms / 1e3), eager_vs=batch * n_steps / (e_ms / 1e3),
               graph_ms=g_ms, eager_ms=e_ms, nodes=stats.get("nodes"), replay_ms=replay)
    if profile:
        prof = profile_run(torch, lambda: graph_run(SWEEP_PROFILE_STEPS), SWEEP_PROFILE_STEPS,
                           "newmark_kernel")
        out["idle"], out["busy_ms"], out["wall_ms"] = prof["idle"], prof["busy_ms"], prof["wall_ms"]
        out["table"] = prof["table"]
    log(f"[sweep] {batch} variants x {n_steps} steps, M5 f64 ({model.solid.ndof} dofs),"
        f" assembly {assembly}: graph {out['graph_vs']:.1f} variant-steps/s ({g_ms:.3f} ms),"
        f" eager {out['eager_vs']:.1f} variant-steps/s ({e_ms:.3f} ms); graph bit-equal to the"
        f" batched eager loop; {stats.get('nodes')} graph nodes a batched step, a replay"
        f" {replay:.3f} ms (the windows' factorizations and refreshes the rest of the run,"
        f" {g_ms - n_steps * replay:.3f} ms); peak device"
        f" memory {peak / 2**20:.1f} MB over the model's; launches a batched step {per_step}"
        + ("" if not profile else f"; profiled graph run: device busy {out['busy_ms']:.3f} ms"
           f" of {out['wall_ms']:.3f} ms wall over {SWEEP_PROFILE_STEPS} steps, idle share"
           f" {out['idle']:.3f}")
        + f"; on {card}")
    if profile:
        log(out["table"])
    return out


def phase_sweep(torch, card, dev):
    """Phase 19 (see the constants above)."""
    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.parallel import sweep

    built = build(torch, dev, "M5_3layers.msh", torch.float64, solid="KelvinVoigtWShape")
    model, state0, cs, prop = built
    gold = np.load(os.path.join(REPO, "tests", "data", "golden_sweep_m5.npz"))
    batch, n_steps = SWEEP_LEG
    require((int(gold["m5_batch"]), int(gold["m5_steps"])) == SWEEP_LEG, "sweep: golden's leg")
    out = {}
    for asm in ("plain", "banded"):
        out[asm] = sweep_leg(torch, card, built, batch, n_steps, asm, profile=asm == "banded")
    leg = out["plain"]
    d_asm = rel_max(out["banded"]["fin"]["u"], leg["fin"]["u"])
    log(f"[sweep] 'banded' vs 'plain' at {batch} x {n_steps}: max|du| / max|u| {d_asm:.3e}"
        f" (gate {SWEEP_ASM_GATE:.0e}); default assembly '{sweep.ASSEMBLY}', faster here:"
        f" '{max(('plain', 'banded'), key=lambda a: out[a]['graph_vs'])}' (graph)")
    require(d_asm <= SWEEP_ASM_GATE, "sweep: 'banded' off 'plain'")
    # the golden rows: the same properties, then the final states
    rows = gold["m5_rows"]
    for k in ("emod", "umesh"):
        require(np.array_equal(leg["pb"][k][rows], gold[f"m5_prop_{k}"]),
                f"sweep: the variants' {k} differ from the golden's")
    fin = leg["fin"]
    for k, kw in (("u", dict(atol=1e-12)), ("q", {}), ("p", dict(atol=1e-8))):
        np.testing.assert_allclose(fin[k][rows], gold[f"m5_fin_{k}"], rtol=SWEEP_GOLDEN_RTOL,
                                   **kw)
    gold_rel = {k: rel_max(fin[k][rows], gold[f"m5_fin_{k}"]) for k in fin}
    require(max(gold_rel.values()) <= SWEEP_GOLDEN_RTOL, f"sweep: golden rows off {gold_rel}")
    # rows run alone: integrate_pure of the variant (its own step graph);
    # the batched products round otherwise than one variant's
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from port_fixtures import newmark_gap

    alone = {}
    for b in SWEEP_ALONE:
        one, traj, _ = forward.integrate_pure(
            model, state0, cs, {k: v[b] for k, v in leg["pb"].items()}, leg["times"],
            leg["params"])
        du = leg["traj_u"][b] - traj["u"].cpu().numpy()
        gap = newmark_gap(np.concatenate([np.zeros_like(du[:1]), du]), 0.0, 0.0, DT)
        alone[b] = sweep_close({k: fin[k][b] for k in fin},
                               {k: v.cpu().numpy() for k, v in one.items()}, gap)
    # one variant's 'banded' run of the same steps launches each kernel as
    # often as the batch of 64 does
    banded = out["banded"]
    _, _, single, _ = run_timed(torch, model, lambda: forward.integrate_pure(
        model, state0, cs, {k: v[0] for k, v in banded["pb"].items()}, banded["times"],
        banded["params"]))
    single = {k: v for k, v in single.items() if v}
    for k in ("newmark", "gather", "scatter"):
        require(banded["launches"][k] == single[k], f"sweep: {k} launched"
                f" {banded['launches'][k]} times for the batch, {single[k]} for one variant")
    log(f"[sweep] golden rows {list(rows)} (tests/data/golden_sweep_m5.npz, the JAX package's"
        f" f64 CPU run) max|diff| / max|ref| {gold_rel} (rtol {SWEEP_GOLDEN_RTOL:.0e}); rows"
        f" {list(SWEEP_ALONE)} against their variants alone, max|diff| / max|ref| (v, a: before"
        f" and after the Newmark gap) {alone} (u: rtol {SWEEP_ALONE_RTOL:.0e}, atol"
        f" {SWEEP_ALONE_ATOL:.0e}); launches of one variant's"
        f" run of the same steps {single}")
    # BASELINE config 5 in the default assembly
    b256, s256 = SWEEP_BASELINE
    sweep_banded_width(torch, model, b256)
    out["baseline"] = sweep_leg(torch, card, built, b256, s256, sweep.ASSEMBLY)
    out["grad"] = sweep_grad_check(torch, card, built)
    out["alone"] = alone
    out["golden"] = gold_rel
    return out


def sweep_banded_width(torch, model, batch):
    """K1/K2 through their vmap rules at a batch's width on the model's
    plan (the batch's channels in one launch each: ``batch`` x 13 gathered,
    ``batch`` x 2 scattered), against the plain versions: the gather
    exactly, the scatter within its summation-order bound."""
    from torch.func import vmap

    from vf_fem_tpu_torch.fem import banded

    plan = model.solid.residual.banded_plan()
    nvert = model.solid.nvert
    rng = np.random.default_rng(batch)
    dev, dt = model.device, model.dtype
    F = torch.tensor(rng.standard_normal((batch, 13, nvert)), dtype=dt, device=dev)
    loc = torch.tensor(rng.standard_normal((batch, plan.nv, 2, plan.ncpad)), dtype=dt, device=dev)
    before = dict(banded.LAUNCHES)
    g = vmap(lambda f: banded.banded_gather(plan, f))(F)
    sc = vmap(lambda x: banded.banded_scatter(plan, x, nvert))(loc)
    launched = {k: banded.LAUNCHES[k] - before[k] for k in ("gather", "scatter")}
    require(launched == {"gather": 1, "scatter": 1}, f"sweep K1/K2 at {batch}: {launched}")
    g_ref = banded.banded_gather_reference(plan, F.reshape(-1, nvert), plan.g)
    require(torch.equal(g, g_ref.reshape(plan.nv, batch, 13, -1).movedim(1, 0)),
            f"sweep K1 at {batch} x 13 channels: not the plain gather")
    flat = loc.movedim(0, 1).reshape(plan.nv, batch * 2, plan.ncpad)
    s_ref = banded.banded_scatter_reference(plan, flat, nvert, plan.s).reshape(batch, 2, nvert)
    bound = banded.scatter_order_bound(plan, flat, nvert, plan.s).reshape(batch, 2, nvert)
    off = int(((sc - s_ref).abs() > 1e-13 * s_ref.abs() + bound).sum())
    require(off == 0, f"sweep K2 at {batch} x 2 channels: {off} entries off")
    log(f"[sweep] K1/K2 under vmap at {batch} variants: one launch each ({batch * 13} channels"
        f" gathered, {batch * 2} scattered), the gather exact, the scatter within its order bound")


def sweep_loss(torch):
    """tests/test_parallel.py:281-285."""
    def loss(traj, controls, prop, times):
        return torch.sum(traj["u"][-1] ** 2) * 1e4 + 1e-6 * torch.sum(traj["q"] ** 2)
    return loss


def sweep_grad_check(torch, card, built):
    """``sweep_grad`` of ``SWEEP_GRAD`` (default adaptive solver, the
    sweep's default assembly): finite, distinct values; variant 2's value
    the forward run's, its shape gradient along a seeded direction against
    central differences of its runs alone (FD_RTOL); K5T launched (the
    batched launch: one a step)."""
    from vf_fem_tpu_torch import forward
    from vf_fem_tpu_torch.parallel import sweep

    model, state0, cs, _ = built
    batch, n_steps = SWEEP_GRAD
    pb = sweep_props(model, batch)
    times = DT * np.arange(n_steps + 1)
    loss = sweep_loss(torch)
    (vals, grads), ms, launches, _ = run_timed(torch, model, lambda: sweep.sweep_grad(
        model, loss, state0, cs, pb, times))
    vals = vals.cpu().numpy()
    g_um = grads["umesh"].cpu().numpy()
    require(np.isfinite(vals).all() and np.isfinite(g_um).all(), "sweep grad: non-finite")
    require(np.unique(vals).size == batch, "sweep grad: values not distinct")
    # the last step's v1, a1 reach no loss: its K5 gets no cotangent
    require(launches["newmark_t"] == n_steps - 1, f"sweep grad: {launches['newmark_t']} K5T"
            f" launches in {n_steps} steps")
    params = {"assembly": sweep.ASSEMBLY}

    def value(p):
        _, traj, _ = forward.integrate_pure(model, state0, cs, p, times, params)
        return float(loss(traj, None, None, None))

    pv = {k: v[2] for k, v in pb.items()}
    d = np.random.default_rng(3).standard_normal(g_um.shape[1])
    d /= np.linalg.norm(d)
    h = SWEEP_FD_H
    fd = (value({**pv, "umesh": pv["umesh"] + h * d})
          - value({**pv, "umesh": pv["umesh"] - h * d})) / (2 * h)
    adj = float(g_um[2] @ d)
    rel = abs(adj - fd) / abs(fd)
    v2 = value(pv)
    log(f"[sweep] sweep_grad {batch} variants x {n_steps} steps (adaptive, assembly"
        f" '{sweep.ASSEMBLY}'): {batch * n_steps / (ms / 1e3):.1f} variant-steps/s"
        f" ({ms:.3f} ms, value+grad); variant 2's value {vals[2]:.12e} (alone {v2:.12e}); its"
        f" shape gradient along a seeded direction {adj:.9e}, central difference {fd:.9e},"
        f" rel diff {rel:.3e} (rtol {FD_RTOL:.0e}); launches {launches}; on {card}")
    require(abs(vals[2] - v2) <= 1e-12 * abs(v2), "sweep grad: value off the variant's alone")
    require(rel <= FD_RTOL, "sweep grad: shape gradient off its central difference")
    return dict(launches=launches, n_steps=n_steps, vs=batch * n_steps / (ms / 1e3), fd_rel=rel)


def main():
    import time

    import torch

    sys.path.insert(0, REPO)
    from vf_fem_tpu_torch import cuda_build  # fails outside a checkout

    name, card = phase_device(torch)
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    sources = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(cuda_build.build, sources))
    log(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.1f} s")
    mesher = start_mesher(*MESH94K)
    mesher3d = start_mesher(*MESH3D)
    children = [mesher[0], mesher3d[0]]
    try:
        m5qz = start_m5_qz(torch, dev)
        children.append(m5qz["proc"])
        run_phases(torch, name, card, dev, t0, mesher, mesher3d, m5qz)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run_phases(torch, name, card, dev, t0, mesher, mesher3d, m5qz):
    import time

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        log(f"[time] {name}: {time.perf_counter() - t:.1f} s (at {time.perf_counter() - t0:.1f} s)")
        return res

    kern = timed("kernels", phase_kernels, torch, dev)
    large = {"float64": build(torch, dev, LARGE_MESH, torch.float64),
             "float32": build(torch, dev, LARGE_MESH, torch.float32)}
    ops_res = timed("ops", phase_ops, torch, dev, large["float64"][0])
    timed("golden", phase_golden, torch, dev)
    head = timed("headline", phase_headline, torch, dev, card)
    kry = timed("krylov", phase_krylov, torch, card, large)
    btd_res = timed("btd", phase_btd, torch, card, large)
    integ = timed("integrate", phase_integrate, torch, card, dev, large, btd_res)
    grad = timed("grad", phase_grad, torch, card, dev, large)
    tang = timed("tangents", phase_tangents, torch, card, dev, large)
    imp = timed("implicit", phase_implicit, torch, card, dev)
    fsai = timed("fsai", phase_fsai, torch, card, dev)
    m94 = timed("mesh94k", phase_mesh94k, torch, card, dev, mesher)
    hopf = timed("hopf", phase_hopf, torch, card, dev, m5qz)
    phys = timed("physics", phase_physics, torch, card, dev, head, btd_res, integ)
    api = timed("api", phase_api, torch, card, dev, large, integ)
    d3 = timed("3d", phase_3d, torch, card, dev, mesher3d)
    dd = timed("dd", phase_dd, torch, card, large, btd_res, integ)
    sw = timed("sweep", phase_sweep, torch, card, dev)

    # per kernel: the timing at the 23.7k shapes of the btd main path (f64)
    timing = {
        "gather": kern[("M5_3layers_rcm_h006", "float64", "gather")],
        "scatter": kern[("M5_3layers_rcm_h006", "float64", "scatter")],
        "ebe_matvec": ops_res[("ebe_matvec", "23.7k cells", "float64")],
        "bsb_matvec": ops_res[("bsb_matvec", "23.7k", "float64")],
        "newmark": ops_res[("newmark", "23.7k", "float64")],
        "btd_sweep": ops_res[("btd_sweep", "forward bfloat16/float64", "float64")],
        "newmark_t": ops_res[("newmark_t", "23.7k", "float64")],
        "btd_sweep_t": ops_res[("btd_sweep_t", "forward bfloat16/float64", "float64")],
        "ebe_matvec_t": ops_res[("ebe_matvec_t", "23.7k cells", "float64")],
        "bsb_matvec_t": ops_res[("bsb_matvec_t", "23.7k", "float64")],
        "gather_t": dd["banded"][("float64", "gather_t")],
        "scatter_t": dd["banded"][("float64", "scatter_t")],
        "btd_sweep_slabs": dd["sweeps"][(DD_SHARDS, "forward", "bfloat16", "float64")],
        **{f"newmark x{b}": ops_res[("newmark", f"M5 x {b}", "float64")]
           for b in (SWEEP_GRAD[0], SWEEP_LEG[0], SWEEP_BASELINE[0])},
        "newmark_t x8": ops_res[("newmark_t", f"M5 x {SWEEP_GRAD[0]}", "float64")],
    }
    # the f64 runs whose launches count: (name, launches, steps)
    runs = [("M5 headline", head["float64"]["launches"], N_STEPS),
            ("23.7k btd", btd_res["float64"]["launches"], btd_res["float64"]["n_steps"]),
            ("23.7k bsb", kry[("bsb", "float64")]["launches"], kry[("bsb", "float64")]["n_steps"]),
            ("23.7k cg", kry[("cg", "float64")]["launches"], kry[("cg", "float64")]["n_steps"]),
            ("M5 value+grad", grad["M5"]["launches"], GRAD_M5_STEPS),
            ("23.7k value+grad", grad["23.7k"]["launches"], N_STEPS),
            ("23.7k cg value+grad", tang["cg"]["launches"], TANGENT_STEPS),
            ("23.7k bsb value+grad", tang["bsb"]["launches"], TANGENT_STEPS),
            ("M5 implicit", imp["float64"]["launches"], N_STEPS),
            ("23.7k implicit btd", imp["23.7k"]["launches"], IMPLICIT_LARGE_STEPS),
            ("23.7k static (a solve)", imp["static"]["launches"], 1),
            ("23.7k static backward", imp["static"]["backward_launches"], 1),
            ("M5 implicit value+grad", imp["grad"]["launches"], IMPLICIT_GRAD_STEPS),
            ("M5 fsai", fsai["float64"]["launches"], fsai["float64"]["n_steps"]),
            ("23.7k fsai btd", fsai[("23.7k", "float64")]["launches"],
             fsai[("23.7k", "float64")]["n_steps"]),
            ("M5 fsai value+grad", fsai["grad"]["launches"], FSAI_GRAD_STEPS),
            ("23.7k fsai value+grad", fsai["grad 23.7k"]["launches"], FSAI_GRAD_STEPS),
            ("94.8k btd", m94["float64"]["launches"], m94["float64"]["n_steps"]),
            ("23.7k hopf (a point)", hopf[HOPF_PSUBS[0]]["launches"], 1),
            ("M5 physics swelling", phys["swelling"]["launches"], N_STEPS),
            ("M5 physics rayleigh", phys["rayleigh"]["launches"], N_STEPS),
            ("23.7k physics btd", phys[("23.7k", "float64")]["launches"], N_STEPS),
            ("M5 stateful golden", api["golden"]["launches"], api["golden"]["n_steps"]),
            *((f"23.7k solve_state1 {k}", v["launches"], v["n_steps"])
              for k, v in api["large"].items()),
            ("M5 phonation", api["phonation"]["launches"], api["phonation"]["n_steps"]),
            *((f"3D small {k}", v["launches"], v["n_steps"]) for k, v in d3["small"].items()),
            ("45.8k 3D btd", d3["float64"]["launches"], d3["float64"]["n_steps"]),
            ("23.7k spike", dd["spike"]["launches"], dd["spike"]["n_steps"]),
            (f"23.7k DD x {DD_SHARDS} banded", dd["step"]["banded"]["launches"], DD_STEPS),
            (f"23.7k DD x {DD_SHARDS} plain", dd["step"]["plain"]["launches"], DD_STEPS),
            ("M5 sweep 64 x 50 plain (a batched step)", sw["plain"]["launches"], SWEEP_LEG[1]),
            ("M5 sweep 64 x 50 banded (a batched step)", sw["banded"]["launches"], SWEEP_LEG[1]),
            ("M5 sweep 256 x 100 (a batched step)", sw["baseline"]["launches"],
             SWEEP_BASELINE[1]),
            ("M5 sweep_grad 8 x 20 (a batched step)", sw["grad"]["launches"], SWEEP_GRAD[1])]
    path = {  # the main-path run whose count is this kernel's ``launches``
        "gather": runs[0][1], "scatter": runs[0][1], "newmark": runs[0][1],
        "btd_sweep": runs[1][1], "ebe_matvec": runs[3][1], "bsb_matvec": runs[2][1],
        "newmark_t": runs[5][1], "btd_sweep_t": runs[5][1],
        "ebe_matvec_t": runs[6][1], "bsb_matvec_t": runs[7][1],
        "gather_t": runs[-6][1], "scatter_t": runs[-6][1], "btd_sweep_slabs": runs[-6][1],
        "newmark x8": runs[-1][1], "newmark x64": runs[-4][1], "newmark x256": runs[-2][1],
        "newmark_t x8": runs[-1][1],
    }
    kernels = []
    for op, (kname, replaces, source) in KERNELS.items():
        r = timing[op]
        counter = KERNEL_COUNTER.get(op, op)
        per_step = {name: launches[counter] / steps for name, launches, steps in runs
                    if launches.get(counter)}
        # the library call's time under both names the kernel table is read
        # by: library_ms (every kernels line) and lib_ms (the table's
        # column), and its device time in a CUDA graph beside the kernel's
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=path[op][counter], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["lib_ms"], lib_ms=r["lib_ms"], lib_call=r["lib_call"],
            library_device_ms=r.get("lib_device_ms"),
            device_ms=r["device_ms"], launches_per_step=per_step, bytes=r["bytes"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
