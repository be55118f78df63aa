"""
Generate the phonation goldens with the JAX package on a CPU, in f64:

    python tests/make_golden_phonation.py [--small] [--m5]

(both without a flag).

- ``--small``: ``tests/data/golden_phonation_small.npz``, the run of
  ``tests/test_phonation.py`` (KelvinVoigt + BernoulliAreaRatioSep on
  ``vocal_fold_mesh(16, 8)``, emod 3e4, eta 2, psub 8000 Ba; 600 steps at
  dt 5e-5, the default adaptive Newton): the minimum glottal width and
  the flow rate at every step, f0 and amplitude of the width's steady two
  thirds (``misc.signal.fundamental_mode_from_rfft``).
- ``--m5``: ``tests/data/golden_phonation_m5.npz``, ``chip_smoke.py``'s
  ``PHONATION`` run (the M5 CAD golden's model at psub 6000 Ba, 1,200 steps
  at dt 5e-5 on the headline solver settings, plain assembly): the same
  series and f0, with the configuration as JSON under ``config``.

Each prints f0, the amplitude and whether the width oscillates
(``misc.signal.is_oscillating``).  Not collected by pytest (its name does
not start with ``test_``); it imports jax, so it is no part of the
PyTorch port.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DATA = os.path.join(TESTS, "data")
for p in (REPO, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

import chip_smoke as cs  # noqa: E402  (its PHONATION and HEADLINE settings)

SMALL = {"nx": 16, "ny": 8, "emod": 3e4, "eta": 2.0, "psub": 8000.0, "dt": 5e-5,
         "n_steps": 600}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def min_glottal_width(model, u_traj):
    """The minimum glottal width 2 (ymid - y) over the interface at every
    step (``postprocess.solid.MinGlottalWidthFromSolid``)."""
    X = np.asarray(model.solid.residual.mesh().coords)
    sdofs = np.asarray(model._solid_dofs)
    ymid = float(np.asarray(model.prop["ymid"])[0])
    y = X[None, sdofs, 1] + np.asarray(u_traj).reshape(len(u_traj), -1, 2)[:, sdofs, 1]
    return (2.0 * (ymid - y)).min(axis=1)


def analyse(gw, dt):
    """f0, amplitude and oscillation of the width's steady two thirds."""
    from vf_fem_tpu.misc.signal import fundamental_mode_from_rfft, is_oscillating

    steady = gw[len(gw) // 3:]
    f0, amp = fundamental_mode_from_rfft(steady, dt)
    return f0, amp, bool(is_oscillating(gw))


def run(model, n_steps, dt, params, path, config):
    from vf_fem_tpu import forward

    ini = model.state0.copy()
    ini[:] = 0.0
    state0 = {k: np.asarray(v) for k, v in ini.sub_items()}
    cs_ = forward._stack_controls(model, [model.control])
    t0 = time.perf_counter()
    _, traj, infos = forward.integrate_pure(model, state0, cs_, model.prop_to_dict(model.prop),
                                            dt * np.arange(n_steps + 1), params)
    gw = min_glottal_width(model, traj["u"])
    q = np.asarray(traj["q"]).reshape(n_steps, -1)[:, 0]
    f0, amp, osc = analyse(gw, dt)
    print(f"{os.path.basename(path)}: {n_steps} steps in {time.perf_counter() - t0:.1f} s;"
          f" f0 {f0:.3f} Hz, amplitude {amp:.4e} cm, oscillating {osc};"
          f" gw in [{gw.min():.4e}, {gw.max():.4e}], q in [{q.min():.3f}, {q.max():.3f}],"
          f" Newton iterations {int(np.asarray(infos.num_iter).sum())}")
    np.savez_compressed(path, gw=gw, q=q, f0=f0, amplitude=amp, oscillating=osc, dt=dt,
                        num_iter=np.asarray(infos.num_iter), config=json.dumps(config))


def make_small():
    _jax()
    from vf_fem_tpu.residuals import fluid as flr

    from fixture_models import make_vf_fsi_model

    model = make_vf_fsi_model(FluidResidual=flr.BernoulliAreaRatioSep, nx=SMALL["nx"],
                              ny=SMALL["ny"])
    model.prop["emod"][:] = SMALL["emod"]
    model.prop["eta"][:] = SMALL["eta"]
    model.set_prop(model.prop)
    model.control["psub"][:] = SMALL["psub"]
    model.set_control(model.control)
    run(model, SMALL["n_steps"], SMALL["dt"], None,
        os.path.join(DATA, "golden_phonation_small.npz"), SMALL)


def make_m5():
    _jax()
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    cfg = cs.PHONATION
    model = load_fsi_model(os.path.join(REPO, "meshes", cfg["mesh"]), getattr(slr, cfg["solid"]),
                           getattr(flr, cfg["fluid"]), coupling="explicit")
    ymax = model.solid.residual.mesh().coords[:, 1].max()
    for k, v in cs.bench_values(ymax).items():
        if k in model.prop:
            model.prop[k][:] = v
    model.set_prop(model.prop)
    model.control["psub"][:] = cfg["psub"]
    model.control["psup"][:] = 0.0
    model.set_control(model.control)
    params = {**cs.HEADLINE, "assembly": "plain"}
    run(model, cfg["n_steps"], cfg["dt"], params,
        os.path.join(DATA, "golden_phonation_m5.npz"),
        {**cfg, "params": params})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--m5", action="store_true")
    args = ap.parse_args()
    both = not (args.small or args.m5)
    if args.small or both:
        make_small()
    if args.m5 or both:
        make_m5()


if __name__ == "__main__":
    main()
