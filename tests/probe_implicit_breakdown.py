"""
Where the implicit bench leg's model stops being solved, in the JAX package
and in the PyTorch port alike, on a CPU in f64:

    python tests/probe_implicit_breakdown.py

The model is ``bench.py``'s ``build_implicit`` (KelvinVoigtWEpithelium +
BernoulliSmoothMinSep, psub 8000 Ba, the contact plane 0.04 cm above the
channel midline).  Prints, for each package:

- M5, the bench leg's settings (``bench.py:493-497``), 20 steps at dt =
  1e-4: each step's Picard iterations and relative residual, and (port)
  the smallest glottal area, which turns negative where the Picard loop
  stops converging;
- M5 value+grad of ``benchmarks/benchmark_adjoint.py``'s loss over 14 and
  20 steps: dJ/dpsub by the coupled IFT rule against a central difference
  (h = 1 Ba);
- 23.7k (``meshes/M5_3layers_rcm_h006.msh``), the production btd settings
  (``bench.py:411-434``) with Aitken, 20 steps: each step's Picard
  residuals and the first non-finite state.

Not collected by pytest (its name does not start with ``test_``); it
imports jax.  It takes a few minutes.
"""

import os
import sys

import numpy as np
import torch

from make_golden_implicit import DT, IMPLICIT, build_implicit
from make_golden_large_bsb import REPO

sys.path.insert(0, REPO)

BTD_PROD = {"assembly": "banded", "linear_solver": "btd", "btd_store_dtype": "bfloat16",
            "jacobian_refresh_steps": 96, "fixed_iterations": 3,
            "fixed_tail_residual": False, "stagnation_ratio": 0.5, "aitken": True}
PROPS = dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, emod_membrane=0.0, nu_membrane=0.3,
             th_membrane=0.0, kcontact=1e8, rho_air=1.1225e-3, zeta_min=1e-3,
             zeta_sep=1e-3)


def port_model(mesh):
    from vf_fem_tpu_torch.load import load_fsi_model
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    m = load_fsi_model(os.path.join(REPO, "meshes", mesh), slr.KelvinVoigtWEpithelium,
                       flr.BernoulliSmoothMinSep, coupling="implicit", device="cpu")
    ymax = m.solid.residual.mesh().coords[:, 1].max()
    for k, v in PROPS.items():
        m.prop[k][:] = v
    m.prop["ycontact"][:] = ymax + 0.05
    m.prop["ymid"][:] = ymax + 0.01
    m.control["psub"][:] = 8000.0
    m.control["psup"][:] = 0.0
    return m


def jax_model(mesh):
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    if mesh == "M5_3layers.msh":
        return build_implicit()
    m = load_fsi_model(os.path.join(REPO, "meshes", mesh), slr.KelvinVoigtWEpithelium,
                       flr.BernoulliSmoothMinSep, coupling="implicit")
    ymax = m.solid.residual.mesh().coords[:, 1].max()
    for k, v in PROPS.items():
        m.prop[k][:] = v
    m.prop["ycontact"][:] = ymax + 0.05
    m.prop["ymid"][:] = ymax + 0.01
    m.set_prop(m.prop)
    m.control["psub"][:] = 8000.0
    m.control["psup"][:] = 0.0
    m.set_control(m.control)
    return m


def runner(pkg, model):
    """(run(control, n, params) -> (traj, infos) as numpy, grad(n) ->
    (adjoint dJ/dpsub, value)) of one package."""
    if pkg == "jax":
        import jax.numpy as jnp
        from vf_fem_tpu import adjoint, forward

        ini = model.state0.copy()
        ini[:] = 0.0
        s0 = {k: np.asarray(v) for k, v in ini.sub_items()}

        def run(psub, n, params):
            c = model.control.copy()
            c["psub"][:] = psub
            _, traj, info = forward.integrate_pure(
                model, s0, forward._stack_controls(model, [c]), model.prop_to_dict(model.prop),
                DT * np.arange(n + 1), params)
            return ({k: np.asarray(v) for k, v in traj.items()},
                    {k: np.asarray(getattr(info, k)) for k in ("num_iter", "abs_err", "rel_err")})

        def grad(n):
            def loss(traj, c, p, t):
                return jnp.sum(traj["q"][-20:] ** 2) * 1e-6

            _, g = adjoint.integrate_grad(model, loss, ini, [model.control], model.prop,
                                          DT * np.arange(n + 1), IMPLICIT)
            return float(np.asarray(g["controls"]["psub"]).sum())
        return run, grad

    from vf_fem_tpu_torch import adjoint, forward

    s0 = {k: np.zeros_like(v) for k, v in model.state0.items()}

    def run(psub, n, params):
        c = {k: v[None].copy() for k, v in model.control.items()}
        c["psub"][:] = psub
        _, traj, info = forward.integrate_pure(model, s0, c, model.prop,
                                               DT * np.arange(n + 1), params)
        return ({k: v.numpy() for k, v in traj.items()},
                {k: getattr(info, k).numpy() for k in ("num_iter", "abs_err", "rel_err")})

    def grad(n):
        def loss(traj, c, p, t):
            return torch.sum(traj["q"][-20:] ** 2) * 1e-6

        _, g = adjoint.integrate_grad(model, loss, s0, [model.control], model.prop,
                                      DT * np.arange(n + 1), IMPLICIT)
        return float(g["controls"]["psub"].sum())
    return run, grad


def fmt(x):
    return [float(f"{v:.3e}") for v in x]


def main():
    for pkg in ("jax", "port"):
        m5 = jax_model("M5_3layers.msh") if pkg == "jax" else port_model("M5_3layers.msh")
        run, grad = runner(pkg, m5)
        traj, info = run(8000.0, 20, IMPLICIT)
        print(f"[{pkg}] M5 bench leg, 20 steps: Picard {info['num_iter'].tolist()}")
        print(f"[{pkg}]   relative residual {fmt(info['rel_err'])}; first above 1e-8 at"
              f" step {int(np.argmax(info['rel_err'] > 1e-8)) + 1}", flush=True)
        if pkg == "port":
            prop = {k: torch.as_tensor(v) for k, v in m5.prop.items()}
            area = [float(m5._area_from_u1(torch.as_tensor(u), prop).min()) for u in traj["u"]]
            print(f"[port]   smallest glottal area {fmt(area)}; first negative at step"
                  f" {int(np.argmax(np.array(area) < 0)) + 1}", flush=True)
        for n in (14, 20):
            adj = grad(n)
            loss = [float(np.sum(run(8000.0 + h, n, IMPLICIT)[0]["q"][-20:] ** 2) * 1e-6)
                    for h in (1.0, -1.0)]
            fd = (loss[0] - loss[1]) / 2.0
            print(f"[{pkg}] M5 value+grad over {n} steps: dJ/dpsub adjoint {adj:.9e}, central"
                  f" difference {fd:.9e}, rel diff {abs(adj - fd) / abs(fd):.3e}", flush=True)
        large = (jax_model if pkg == "jax" else port_model)("M5_3layers_rcm_h006.msh")
        run, _ = runner(pkg, large)
        traj, info = run(8000.0, 20, BTD_PROD)
        finite = np.isfinite(traj["u"]).all(axis=1)
        print(f"[{pkg}] 23.7k btd prod + Aitken, 20 steps: Picard {info['num_iter'].tolist()},"
              f" relative residual {fmt(info['rel_err'])}; first non-finite state at step"
              f" {int(np.argmin(finite)) + 1 if not finite.all() else None}", flush=True)


if __name__ == "__main__":
    main()
