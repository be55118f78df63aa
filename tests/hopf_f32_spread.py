"""
Why the port factors ``factor_dtype='float32'`` in float64 and stores the
factors in float32, where the JAX package factors in float32.

On ``tests/test_hopf.py:147-173``'s banded test models (RCM vocal-fold
mesh 8 x 4, psub 8000 Ba, sigma = 2 pi i 130, m 60), the unrefined
(``refine=0``) float32-factor run's leading mode is printed against the
float64 run's, beside ``tests/test_hopf.py:206-265``'s gates (growth 3e-3
of |lambda_0|, frequency rtol 1e-3), for:

- the port as it ships (factored in float64, stored in float32);
- the JAX package's own float32 pipeline;
- the port factored in float32, with the Schur inverses of torch
  (LAPACK) or of ``jax.numpy.linalg.solve``, and with every entry of the
  float32 Schur complement moved by one ulp up or down (six seeds each):
  equally valid float32 factorizations of one system;

then the default refinement (2) for the port as it ships and factored in
float32.  It also prints the condition number of the embedded,
equilibrated Schur complement and each float32 inverse's error.

    python tests/hopf_f32_spread.py

takes about 70 s on an 8-core CPU (two torch threads).
"""

import os
import sys
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vf_fem_tpu.load import load_fsi_model as jax_load  # noqa: E402
from vf_fem_tpu.mesh import vocal_fold_mesh as jax_vf_mesh  # noqa: E402
from vf_fem_tpu.mesh.reorder import rcm_mesh as jax_rcm  # noqa: E402
from vf_fem_tpu.misc.hopf import linear_stability as jax_linear_stability  # noqa: E402
from vf_fem_tpu.residuals import fluid as jflr, solid as jslr  # noqa: E402
from vf_fem_tpu_torch.load import load_fsi_model  # noqa: E402
from vf_fem_tpu_torch.mesh import vocal_fold_mesh  # noqa: E402
from vf_fem_tpu_torch.mesh.reorder import rcm_mesh  # noqa: E402
from vf_fem_tpu_torch.misc import hopf  # noqa: E402
from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr  # noqa: E402
from vf_fem_tpu_torch.solvers import cbtd  # noqa: E402

SIGMA = 1j * 2 * np.pi * 130.0
PSUB = 8000.0
SEEDS = range(6)


def props(ymax):
    return dict(emod=3e4, rho=1.0, eta=2.0, ycontact=ymax + 0.05, kcontact=1e8,
                rho_air=1.1225e-3, zeta_min=1e-3, zeta_sep=1e-3, ymid=ymax + 0.01)


def port_models():
    mesh = rcm_mesh(vocal_fold_mesh(8, 4))
    models = []
    for model_type in ("transient", "dynamical"):
        m = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                           model_type=model_type, device="cpu")
        for k, v in props(mesh.coords[:, 1].max()).items():
            m.prop[k][:] = v
        models.append(m)
    return models


def jax_models():
    mesh = jax_rcm(jax_vf_mesh(8, 4))
    models = []
    for model_type in ("transient", "dynamical"):
        m = jax_load(mesh, jslr.KelvinVoigt, jflr.BernoulliSmoothMinSep, model_type=model_type)
        for k, v in props(mesh.coords[:, 1].max()).items():
            m.prop[k][:] = v
        m.set_prop(m.prop)
        models.append(m)
    return models


def lapack_inverse(S):
    return torch.linalg.solve_ex(S, torch.eye(S.shape[0], dtype=S.dtype))[0]


def jax_inverse(S):
    eye = jnp.eye(S.shape[0], dtype=jnp.float32)
    return torch.from_numpy(np.array(jnp.linalg.solve(jnp.asarray(S.numpy()), eye)))


def one_ulp(seed, inverse):
    """``inverse`` of S with every entry moved one float32 ulp, up or down
    at random."""
    def inv(S):
        a = S.numpy()
        up = np.random.default_rng(seed).random(a.shape) < 0.5
        toward = np.where(up, np.float32(np.inf), np.float32(-np.inf)).astype(np.float32)
        return inverse(torch.as_tensor(np.nextafter(a, toward)))
    return inv


def thomas_with(inverse, conds):
    """``btd.thomas_factor`` with the Schur inverses taken by ``inverse``;
    appends each complement's condition number and its inverse's error."""
    def thomas(D, L, U, what):
        Sinv, W = torch.empty_like(D), torch.empty_like(D)
        for i in range(D.shape[0]):
            if i:
                W[i - 1] = Sinv[i - 1] @ U[i - 1]
            S = D[i] - L[i] @ W[i - 1] if i else D[0]
            Sinv[i] = inverse(S)
            exact = torch.linalg.inv(S.double())
            err = (Sinv[i].double() - exact).abs().max() / exact.abs().max()
            conds.append((torch.linalg.cond(S.double()).item(), err.item()))
        W[-1] = Sinv[-1] @ U[-1]
        return Sinv, torch.bmm(Sinv, L), W
    return thomas


def main():
    torch.set_num_threads(2)
    warnings.simplefilter("ignore", RuntimeWarning)
    tm, dm = port_models()
    c = {"psub": np.array([PSUB]), "psup": np.array([0.0])}
    kw = dict(solver="banded", sigma=SIGMA, arnoldi_m=60, return_info=True)
    e64, _, _ = hopf.linear_stability(tm, dm, c, tm.prop, **kw)
    s64, f64 = hopf.growth_rate_and_frequency(e64)
    scale = abs(e64[0])
    print(f"float64 factors: leading mode {s64:+.6f} 1/s at {f64:.6f} Hz")

    def report(label, run):
        try:
            eigs, _, info = run()
        except RuntimeError as err:
            print(f"{label:46s} raised: {str(err)[:90]}")
            return
        s, f = hopf.growth_rate_and_frequency(eigs)
        print(f"{label:46s} growth off {abs(s - s64) / scale:.3e} of |lambda_0| (gate 3e-3),"
              f" frequency off {abs(f - f64) / f64:.3e} (gate 1e-3), res_rel max"
              f" {info['res_rel'].max():.3e}, {len(eigs)} modes")

    def port(refine=0):
        return lambda: hopf.linear_stability(tm, dm, c, tm.prop, factor_dtype="float32",
                                             refine=refine, **kw)

    report("port as shipped (f64 factored, f32 stored)", port())
    jtm, jdm = jax_models()
    jc = jtm.control.copy()
    jc["psub"][:] = PSUB
    jc["psup"][:] = 0.0
    report("JAX package (f32 factored)", lambda: jax_linear_stability(
        jtm, jdm, jc, jtm.prop, factor_dtype="float32", refine=0, **kw))

    factor, thomas = cbtd.cbtd_factor, cbtd.thomas_factor
    cbtd.cbtd_factor = lambda plan, re, im: factor(plan, re.float(), im.float())
    conds = []
    variants = [("port f32 factored, LAPACK inverse", lapack_inverse),
                ("port f32 factored, JAX inverse", jax_inverse)]
    for seed in SEEDS:
        variants += [(f"  the same, S +-1 ulp (seed {seed}), LAPACK", one_ulp(seed, lapack_inverse)),
                     (f"  the same, S +-1 ulp (seed {seed}), JAX", one_ulp(seed, jax_inverse))]
    try:
        for label, inverse in variants:
            cbtd.thomas_factor = thomas_with(inverse, conds)
            report(label, port())
        cbtd.thomas_factor = thomas
        report("port f32 factored, refine 2", port(2))
    finally:
        cbtd.cbtd_factor, cbtd.thomas_factor = factor, thomas
    report("port as shipped, refine 2", port(2))
    cond = [x[0] for x in conds]
    err = [x[1] for x in conds]
    print(f"embedded equilibrated Schur complements: condition number {min(cond):.3e} to"
          f" {max(cond):.3e}; float32 inverses off the exact one by {min(err):.3e} to"
          f" {max(err):.3e} of its largest entry")


if __name__ == "__main__":
    main()
