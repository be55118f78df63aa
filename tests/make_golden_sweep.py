"""
Generate the sweep goldens with the JAX package on a CPU (f64):

    python tests/make_golden_sweep.py [--skip-m5]

``tests/data/golden_sweep.npz``, the two cases of ``tests/test_parallel.py``
(``vocal_fold_mesh(6, 3)``, KelvinVoigt(WShape) + BernoulliSmoothMinSep,
``times = 2e-5 * arange(6)``, default adaptive solver parameters, the
assembly ``sweep_integrate`` pins):

- ``stiff_*``: the stiffness sweep, 8 variants, ``emod`` 4e4 ... 8e4
  (``test_parallel.py:27-41``), through ``parallel.sweep_integrate``: the
  final state of every variant and its infos, and the trajectory of u of
  the same batch through ``vmap(integrate_pure)`` (what
  ``sweep_integrate`` runs; its final state is asserted equal);
- ``grad_*``: the geometry + stiffness sweep, 4 variants, ``emod`` 4e4 ...
  8e4 and ``umesh`` = scale * bump, scale -1 ... 1
  (``test_parallel.py:238-294``), through
  ``vmap(value_and_grad(loss))``: the values and the gradients in
  ``emod`` and ``umesh``.

``tests/data/golden_sweep_m5.npz``, the batched sweep leg of ``bench.py``
(``:612-697``): ``build_sweep`` (``:748-785``: ``meshes/M5_3layers.msh``,
KelvinVoigtWShape + BernoulliAreaRatioSep), the leg's bump and ``emod`` for
64 variants and its settings ``tol_s``, 50 steps of dt = 1e-4 from rest.
Stored: variants 0, 9, 18, ..., 63 (``m5_rows``), their properties and
final states.  The rows of a vmapped batch do not depend on each other, so
the script runs those 8 variants as one vmapped batch (about two minutes
on an 8-core CPU).

Not collected by pytest (its name does not start with ``test_``); it
imports jax, so it is no part of the PyTorch port.
"""

import argparse
import os
import sys
import time

import numpy as np

from make_golden_large_bsb import REPO, _jax

OUT = os.path.join(REPO, "tests", "data", "golden_sweep.npz")
OUT_M5 = os.path.join(REPO, "tests", "data", "golden_sweep_m5.npz")
TIMES = 2e-5 * np.arange(6)
STIFF_BATCH = 8
GRAD_BATCH = 4
# bench.py:624-664
M5_BATCH, M5_STEPS, M5_DT = 64, 50, 1e-4
M5_ROWS = np.arange(0, M5_BATCH, 9)
M5_PARAMS = {
    "jacobian_refresh_steps": 8,
    "jacobian_refresh_mode": "ns",
    "jacobian_full_refresh_windows": 8,
    "stagnation_ratio": 0.5,
    "fixed_iterations": 2,
    "jacobian_refresh_precision": "default",
    "assembly": "plain",
}


def bump(X: np.ndarray) -> np.ndarray:
    """The y-bump of the whole fold (``test_parallel.py:271-279``,
    ``bench.py:641-649``), vertex-major (nvert, 2)."""
    out = np.zeros_like(X)
    out[:, 1] = (0.004 * np.sin(np.pi * (X[:, 0] - X[:, 0].min()) / max(np.ptp(X[:, 0]), 1e-9))
                 * (X[:, 1] - X[:, 1].min()) / max(np.ptp(X[:, 1]), 1e-9))
    return out


def small_batch(prop0: dict, batch: int, X=None) -> dict:
    """``test_parallel.py``'s batch: ``emod`` 4e4 ... 8e4, and with the
    reference coordinates ``X`` the geometry scales -1 ... 1."""
    pb = {k: np.stack([np.asarray(v)] * batch) for k, v in prop0.items()}
    pb["emod"] = np.broadcast_to(np.linspace(4e4, 8e4, batch)[:, None],
                                 (batch,) + np.shape(prop0["emod"])).copy()
    if X is not None:
        pb["umesh"] = np.linspace(-1.0, 1.0, batch)[:, None] * bump(X).reshape(-1)[None, :]
    return pb


def m5_batch(prop0: dict, X: np.ndarray) -> dict:
    """``bench.py:628-655``: the 64 variants' properties."""
    pb = {k: np.broadcast_to(np.asarray(v), (M5_BATCH,) + np.shape(v)).copy()
          for k, v in prop0.items()}
    pb["emod"] = np.broadcast_to(np.linspace(4e4, 6e4, M5_BATCH)[:, None],
                                 (M5_BATCH,) + np.shape(prop0["emod"])).copy()
    pb["umesh"] = (np.linspace(-1.0, 1.0, M5_BATCH)[:, None]
                   * bump(X).reshape(-1)[None, :])
    return pb


def loss_of(traj_u_last, traj_q):
    """``test_parallel.py:281-285``'s loss of a run."""
    import jax.numpy as jnp

    return jnp.sum(traj_u_last ** 2) * 1e4 + 1e-6 * jnp.sum(traj_q ** 2)


def small_cases() -> dict:
    _jax()
    import jax
    import jax.numpy as jnp

    from vf_fem_tpu import forward
    from vf_fem_tpu.parallel import sweep_integrate
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from fixture_models import make_vf_fsi_model

    out = {"times": TIMES}
    model = make_vf_fsi_model(FluidResidual=flr.BernoulliSmoothMinSep, nx=6, ny=3)
    state0 = {k: np.zeros_like(np.asarray(v)) for k, v in model.state0.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    pb = small_batch(model.prop_to_dict(model.prop), STIFF_BATCH)
    fin, infos = sweep_integrate(model, state0, cs,
                                 {k: jnp.asarray(v) for k, v in pb.items()}, TIMES)
    params = {"assembly": "plain"}  # what sweep_integrate pins
    vfin, traj, _ = jax.vmap(lambda p: forward.integrate_pure(
        model, state0, cs, p, jnp.asarray(TIMES), params))({k: jnp.asarray(v) for k, v in pb.items()})
    for k, v in fin.items():
        np.testing.assert_array_equal(np.asarray(vfin[k]), np.asarray(v))
    out["stiff_traj_u"] = np.asarray(traj["u"])
    out.update({f"stiff_prop_{k}": v for k, v in pb.items()})
    out.update({f"stiff_fin_{k}": np.asarray(v) for k, v in fin.items()})
    out.update({f"stiff_info_{k}": np.asarray(getattr(infos, k))
                for k in ("num_iter", "abs_err", "rel_err")})

    model = make_vf_fsi_model(SolidResidual=slr.KelvinVoigtWShape,
                              FluidResidual=flr.BernoulliSmoothMinSep, nx=6, ny=3)
    state0 = {k: jnp.zeros_like(jnp.asarray(np.asarray(v)))
              for k, v in model.state0.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    pb = small_batch(model.prop_to_dict(model.prop), GRAD_BATCH,
                     np.asarray(model.solid._Xref))
    times = jnp.asarray(TIMES)

    def loss(p):
        fin, traj, infos = forward.integrate_pure(model, state0, cs, p, times,
                                                  use_remat=True)
        return loss_of(fin["u"], traj["q"])

    vals, grads = jax.vmap(jax.value_and_grad(loss))({k: jnp.asarray(v) for k, v in pb.items()})
    out.update({f"grad_prop_{k}": v for k, v in pb.items()})
    out["grad_values"] = np.asarray(vals)
    out["grad_emod"] = np.asarray(grads["emod"])
    out["grad_umesh"] = np.asarray(grads["umesh"])
    return out


def build_sweep():
    """``bench.py:748-785``."""
    _jax()
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.mesh import load_gmsh
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    mesh = load_gmsh(os.path.join(REPO, "meshes", "M5_3layers.msh"))
    ymax = mesh.coords[:, 1].max()
    model = load_fsi_model(mesh, slr.KelvinVoigtWShape, flr.BernoulliAreaRatioSep,
                           coupling="explicit")
    prop = model.prop
    for k, v in dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, ycontact=ymax + 0.05,
                     kcontact=1e8, rho_air=1.1225e-3, r_sep=1.0, area_lb=1e-4,
                     ymid=ymax + 0.01).items():
        prop[k][:] = v
    model.set_prop(prop)
    model.control["psub"][:] = 8000.0
    model.control["psup"][:] = 0.0
    model.set_control(model.control)
    return model


def m5_case() -> dict:
    jax = _jax()
    import jax.numpy as jnp

    from vf_fem_tpu import forward

    model = build_sweep()
    state0 = {k: jnp.zeros_like(jnp.asarray(np.asarray(v)))
              for k, v in model.state0.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    pb = m5_batch(model.prop_to_dict(model.prop), np.asarray(model.solid._Xref))
    rows = {k: v[M5_ROWS] for k, v in pb.items()}
    times = jnp.asarray(M5_DT * np.arange(M5_STEPS + 1))

    def run_one(p):
        fin, traj, infos = forward.integrate_pure(model, state0, cs, p, times, M5_PARAMS)
        return fin

    fin = jax.jit(jax.vmap(run_one))({k: jnp.asarray(v) for k, v in rows.items()})
    out = {"m5_rows": M5_ROWS, "m5_batch": M5_BATCH, "m5_steps": M5_STEPS, "m5_dt": M5_DT}
    out.update({f"m5_prop_{k}": v for k, v in rows.items()})
    out.update({f"m5_fin_{k}": np.asarray(v) for k, v in fin.items()})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-m5", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    np.savez_compressed(OUT, **small_cases())
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f} s")
    if not args.skip_m5:
        t0 = time.perf_counter()
        np.savez_compressed(OUT_M5, **m5_case())
        print(f"wrote {OUT_M5} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
