"""
Generate the golden of the batched direct solvers and the FSAI batch with
the JAX package on a CPU (f64):

    python tests/make_golden_sweep_solvers.py

``tests/data/golden_sweep_solvers.npz``: each case of
``tests/sweep_solver_cases.py`` through the JAX package's
``parallel.sweep``: ``sweep_integrate`` of a 'run' case (the final state of
every variant, ``<case>|fin|<key>``, and its Newton iterations,
``<case>|num_iter``) and ``sweep_grad`` of a 'grad' case (the values,
``<case>|values``, and every property's gradient, ``<case>|grad|<key>``),
with the batch's properties (``<case>|prop|<key>``).  About five minutes
on an 8-core CPU, the compiles of the vmapped scans dominate.

Not collected by pytest (its name does not start with ``test_``); it
imports jax, so it is no part of the PyTorch port.
"""

import os
import sys
import time

import numpy as np

from make_golden_large_bsb import REPO, _jax

OUT = os.path.join(REPO, "tests", "data", "golden_sweep_solvers.npz")


def main():
    _jax()
    import jax.numpy as jnp

    from vf_fem_tpu.functional.acoustic import RmsRadiatedPressure
    from vf_fem_tpu.parallel import sweep

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import sweep_solver_cases as sc
    from port_fixtures import jax_inputs

    out = {}
    models = {}
    for name, (mname, _, _, params, kind) in sc.CASES.items():
        t0 = time.perf_counter()
        jm = models.get(mname) or models.setdefault(mname, sc.jax_model(mname))
        state0, cs, prop = jax_inputs(jm)
        pb = sc.batch(prop)
        times = jnp.asarray(sc.times_of(name, float(jm.dt)))
        jpb = {k: jnp.asarray(v) for k, v in pb.items()}
        out.update({f"{name}|prop|{k}": v for k, v in pb.items()})
        if kind == "run":
            fin, infos = sweep.sweep_integrate(jm, state0, cs, jpb, times, params)
            out.update({f"{name}|fin|{k}": np.asarray(v) for k, v in fin.items()})
            out[f"{name}|num_iter"] = np.asarray(infos.num_iter)
        else:
            loss = (sc.fsai_loss(RmsRadiatedPressure(jm), state0, jnp) if mname == "fsai"
                    else sc.fsi_loss(jnp))
            vals, grads = sweep.sweep_grad(jm, loss, state0, cs, jpb, times, params)
            out[f"{name}|values"] = np.asarray(vals)
            out.update({f"{name}|grad|{k}": np.asarray(v) for k, v in grads.items()})
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    out["times_dt_fsai"] = np.asarray(float(models["fsai"].dt))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e3:.1f} kB)")


if __name__ == "__main__":
    main()
