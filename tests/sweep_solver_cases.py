"""
The batches of variants on the block direct solvers ('btd', 'spike') and on
the FSAI model that ``tests/make_golden_sweep_solvers.py`` runs through the
JAX package's ``parallel.sweep`` (into ``tests/data/golden_sweep_solvers.npz``)
and ``tests/test_torch_sweep_btd.py``, ``test_torch_sweep_spike.py`` and
``test_torch_sweep_fsai.py`` run through the port's: the models, the
batches, the solver settings and the losses, from the same numpy inputs.

Each case is ``(model, batch, times, params)``; ``model`` names a builder
below, the batch is :func:`batch` of the model's properties (``B``
variants, emod 4e4 ... 6e4), the params are what both packages' sweeps
take (``sweep_integrate`` pins assembly 'plain' in both).
"""

import numpy as np

B = 3
# tests/test_torch_btd.py: PROD_SMALL, bench.py:411-434 with the refresh
# window cut to 8 steps
PROD_SMALL = {"linear_solver": "btd", "btd_store_dtype": "bfloat16",
              "jacobian_refresh_steps": 8, "fixed_iterations": 3,
              "fixed_tail_residual": False, "stagnation_ratio": 0.5}
BTD_F64 = {k: v for k, v in PROD_SMALL.items() if k != "btd_store_dtype"}
SPIKE_F64 = {**BTD_F64, "linear_solver": "spike", "spike_partitions": 4}
SPIKE_BF16 = {**SPIKE_F64, "btd_store_dtype": "bfloat16"}
GRAD_STEPS = 6

# name: (model, steps, dt, params, kind) with kind 'run' (the final
# states) or 'grad' (values and gradients of the case's loss)
CASES = {
    # the RCM vocal_fold_mesh(24, 6): three super-rows of 128, so that each
    # variant's chain has an interior row
    "btd_f64": ("btd", 12, 1e-4, BTD_F64, "run"),
    # tests/test_torch_btd.py's own model and 20-step run, where its
    # PROD_SMALL_DIFF tolerances were measured
    "btd_bf16": ("btd_small", 20, 1e-4, PROD_SMALL, "run"),
    "btd_grad_stale": ("btd", GRAD_STEPS, 1e-4,
                       {**BTD_F64, "jacobian_refresh_steps": 4, "adjoint_refine": "stale"},
                       "grad"),
    "btd_grad_exact": ("btd", GRAD_STEPS, 1e-4,
                       {**BTD_F64, "jacobian_refresh_steps": 4, "adjoint_refine": "exact"},
                       "grad"),
    # tests/test_torch_spike.py's FSI model (tests/test_spike.py:77-143)
    "spike_f64": ("spike", 12, 5e-5, SPIKE_F64, "run"),
    "spike_bf16": ("spike", 12, 5e-5, SPIKE_BF16, "run"),
    "spike_grad": ("spike", GRAD_STEPS, 5e-5, {**SPIKE_F64, "jacobian_refresh_steps": 4},
                   "grad"),
    # tests/test_fsai.py's 8 x 4 model, 12 tubes, at the tract's dt
    "fsai": ("fsai", 20, None, {}, "run"),
    "fsai_grad": ("fsai", 20, None, {}, "grad"),
}


def batch(prop: dict) -> dict:
    """``B`` variants of ``prop`` (numpy arrays), emod 4e4 ... 6e4."""
    pb = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy() for k, v in prop.items()}
    pb["emod"] = np.linspace(4e4, 6e4, B)[:, None] * np.ones(np.shape(prop["emod"]))
    return pb


def times_of(name: str, dt: float) -> np.ndarray:
    _, steps, case_dt, _, _ = CASES[name]
    return (case_dt if case_dt is not None else dt) * np.arange(steps + 1)


def jax_model(name: str):
    """The JAX package's model of a case's model name."""
    from port_fixtures import jax_vf_model, set_dd_props

    if name == "btd":
        return jax_vf_model("KelvinVoigtWEpithelium", 24, 6, reorder="rcm")
    if name == "btd_small":
        return jax_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
    if name == "spike":
        from vf_fem_tpu.load import load_fsi_model
        from vf_fem_tpu.mesh import vocal_fold_mesh
        from vf_fem_tpu.mesh.reorder import rcm_mesh
        from vf_fem_tpu.residuals import fluid as flr, solid as slr

        mesh = rcm_mesh(vocal_fold_mesh(10, 5))
        jm = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                            coupling="explicit")
        set_dd_props(jm.prop, jm.control, mesh.coords[:, 1].max())
        jm.set_prop(jm.prop)
        jm.set_control(jm.control)
        return jm
    from test_fsai import make_fsai_model

    return make_fsai_model(nx=8, ny=4)


def port_model(name: str, jm=None):
    """The port's twin of :func:`jax_model` (the FSAI one takes the JAX
    model's properties, ``jm``, or builds it)."""
    from port_fixtures import port_dd_model, port_fsai_model, port_vf_model

    if name == "btd":
        return port_vf_model("KelvinVoigtWEpithelium", 24, 6, reorder="rcm")
    if name == "btd_small":
        return port_vf_model("KelvinVoigtWEpithelium", 10, 5, reorder="rcm")
    if name == "spike":
        return port_dd_model(10, 5)
    return port_fsai_model(jm if jm is not None else jax_model("fsai"), nx=8, ny=4)


def fsi_loss(lib):
    """``tests/test_parallel.py:281-285``'s loss of a variant's trajectory
    (``lib``: jax.numpy or torch)."""

    def loss(traj, controls, prop, times):
        return lib.sum(traj["u"][-1] ** 2) * 1e4 + 1e-6 * lib.sum(traj["q"] ** 2)

    return loss


def fsai_loss(functional, state0, lib):
    """The RMS radiated pressure (``functional.acoustic.RmsRadiatedPressure``
    of either package, ``functional``) of a variant's trajectory with the
    initial state in front, as ``tests/test_torch_fsai_grad.py`` takes it."""

    def loss(traj, controls, prop, times):
        full = {k: lib.concatenate([lib.asarray(state0[k])[None], traj[k]], axis=0)
                if lib.__name__.startswith("jax") else
                lib.cat([lib.as_tensor(state0[k], dtype=traj[k].dtype)[None], traj[k]])
                for k in traj}
        return functional.eval_traj(full, times, controls, prop)

    return loss
