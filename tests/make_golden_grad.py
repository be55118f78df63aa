"""
Generate ``tests/data/golden_grad.npz`` with the JAX package on a CPU
(f64), the gradients and tangents that the port's gradient tests hold it
to where the JAX package takes too long to trace for the tier-1 tests
(``tests/_slow_ids.py``):

    python tests/make_golden_grad.py [--only spike,dd,3d]

- ``spike_*`` (``tests/test_torch_spike_grad.py``): the fold of
  ``tests/test_spike.py:77-143`` (the RCM-renumbered ``vocal_fold_mesh(10,
  5)``, KelvinVoigt + BernoulliSmoothMinSep, the properties of
  ``tests/test_ddstep._make_model``), 6 steps of 5e-5 s from rest,
  ``linear_solver='spike'`` with 4 partitions and factors refreshed every 3
  steps: ``spike_value`` and ``spike_grad_<key>`` of ``1e4 sum(u_final^2)``
  (the refined stale adjoint), and ``spike_tangent_<key>``, the final state
  of ``jax.jvp`` of the forward-mode integrator along the tangents of
  ``port_fixtures.seeded_tangents`` (seed 4).
- ``dd_*`` (``tests/test_torch_dd_grad.py``): the gradients of
  ``tests/test_ddstep.py:123-167``, the RCM-renumbered 40 x 20 fold, 8
  steps of 5e-5 s, ``1e4 sum(u_final^2) + 1e-6 sum(q^2)`` in every
  property: ``dd_plain_*`` / ``dd_banded_*``, ``parallel.ddstep.
  DDIntegrator`` over 4 shards of the virtual CPU mesh with
  ``jacobian_refresh_steps`` 4 and the indexed or banded cell pass, and
  ``dd_single_*``, ``forward.integrate_pure`` on one device refactored
  every step; each a ``value`` and a ``grad_<key>`` a property.
- ``3d_*`` (``tests/test_torch_btd_3d_grad.py``): the small extruded stack
  of ``tests/cases_3d.py`` (``btd3d``, 477 dofs), 8 steps of 5e-5 s,
  banded assembly, ``linear_solver='btd'`` refreshed every 4 steps
  (``tests/test_bsb.py:399-480``'s settings), ``1e4 sum(u_final^2)``:
  ``3d_value`` and ``3d_grad_<key>``.

About 4 minutes on an 8-core CPU.  Not collected by pytest (its name does
not start with ``test_``); it imports jax, so it is no part of the PyTorch
port.
"""

import argparse
import os
import sys
import time

import numpy as np

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

from make_golden_large_bsb import REPO, _jax  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "golden_grad.npz")
SPIKE_TIMES = 5e-5 * np.arange(7)
SPIKE = {"linear_solver": "spike", "spike_partitions": 4, "jacobian_refresh_steps": 3}
SPIKE_TANGENT_SEED = 4
DD_SHAPE = (40, 20, 4, 4)  # nx, ny, shards, refresh
DD_TIMES = 5e-5 * np.arange(9)
G3D_TIMES = 5e-5 * np.arange(9)
G3D = {"assembly": "banded", "linear_solver": "btd", "jacobian_refresh_steps": 4}


def _dd_model(nx, ny):
    from port_fixtures import set_dd_props
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.mesh import vocal_fold_mesh
    from vf_fem_tpu.mesh.reorder import rcm_mesh
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    mesh = rcm_mesh(vocal_fold_mesh(nx, ny))
    model = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                           coupling="explicit")
    set_dd_props(model.prop, model.control, mesh.coords[:, 1].max())
    model.set_prop(model.prop)
    model.set_control(model.control)
    return model


def _grad(out, name, fn, arg):
    import jax

    t0 = time.time()
    v, g = jax.value_and_grad(fn)(arg)
    out[f"{name}_value"] = np.asarray(v)
    for k, x in g.items():
        out[f"{name}_grad_{k}"] = np.asarray(x)
    print(f"{name}: value {float(v)!r} in {time.time() - t0:.1f} s", flush=True)


def spike_part(out):
    import jax
    import jax.numpy as jnp
    from port_fixtures import jax_inputs, seeded_tangents
    from vf_fem_tpu import forward

    model = _dd_model(10, 5)
    s0, cs, prop = jax_inputs(model)

    def loss(p):
        fin, _, _ = forward.integrate_pure(model, s0, cs, p, SPIKE_TIMES, SPIKE, use_remat=True)
        return jnp.sum(fin["u"] ** 2) * 1e4

    _grad(out, "spike", loss, prop)
    tangents = seeded_tangents(s0, cs, prop, SPIKE_TIMES, SPIKE_TANGENT_SEED)

    def run(*a):
        return forward.integrate_pure(model, *a, SPIKE, mode="fwd")[0]

    _, jd = jax.jvp(run, (s0, cs, prop, jnp.asarray(SPIKE_TIMES)),
                    tuple(jnp.asarray(t) if not isinstance(t, dict) else t for t in tangents))
    for k, v in jd.items():
        out[f"spike_tangent_{k}"] = np.asarray(v)


def dd_part(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from vf_fem_tpu import forward
    from vf_fem_tpu.parallel.ddstep import DDIntegrator

    nx, ny, shards, refresh = DD_SHAPE
    model = _dd_model(nx, ny)
    state0 = {k: np.zeros_like(np.asarray(v)) for k, v in model.state0.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    pd = model.prop_to_dict(model.prop)

    def loss_of(fin, traj):
        return jnp.sum(fin["u"] ** 2) * 1e4 + 1e-6 * jnp.sum(traj["q"] ** 2)

    def single(p):
        fin, traj, _ = forward.integrate_pure(
            model, state0, cs, p, DD_TIMES, {"jacobian_refresh_steps": 1}, use_remat=True)
        return loss_of(fin, traj)

    _grad(out, "dd_single", single, pd)
    devices = Mesh(np.asarray(jax.devices("cpu")[:shards]), ("shard",))
    for asm in ("plain", "banded"):
        dd = DDIntegrator(model, devices, params={"jacobian_refresh_steps": refresh,
                                                  "assembly": asm}, use_remat=True)

        def dd_loss(p, dd=dd):
            fin, traj, _ = dd.integrate_pure(state0, cs, p, DD_TIMES)
            return loss_of(fin, traj)

        _grad(out, f"dd_{asm}", dd_loss, pd)


def part_3d(out):
    import jax.numpy as jnp
    import cases_3d
    import dynamical_cases
    from vf_fem_tpu import forward

    model, _, _ = cases_3d.build(dynamical_cases.jax_pkg(), "btd3d")
    state0 = {k: np.zeros_like(np.asarray(v)) for k, v in model.state0.sub_items()}
    cs = forward._stack_controls(model, [model.control])
    pd = model.prop_to_dict(model.prop)

    def loss(p):
        fin, _, _ = forward.integrate_pure(model, state0, cs, p, G3D_TIMES, G3D, use_remat=True)
        return jnp.sum(fin["u"] ** 2) * 1e4

    _grad(out, "3d", loss, pd)


PARTS = {"spike": spike_part, "dd": dd_part, "3d": part_3d}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PARTS),
                    help="comma-separated parts to remake (the others are kept)")
    args = ap.parse_args()
    jax = _jax()
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    out = dict(np.load(OUT)) if os.path.exists(OUT) else {}
    for name in args.only.split(","):
        out = {k: v for k, v in out.items() if not k.startswith(name + "_")}
        PARTS[name](out)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
