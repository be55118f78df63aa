"""
Generate the linear-stability (Hopf) goldens with the JAX package on a CPU
in float64:

    python tests/make_golden_hopf.py                # every file
    python tests/make_golden_hopf.py --small        # the small Hopf one only
    python tests/make_golden_hopf.py --dynamical    # the dynamical models' only

Runs:

- **23.7k** (``tests/data/golden_hopf_23k.npz``): the Hopf leg of
  ``bench.py`` (``bench.py:533-575``: ``meshes/M5_3layers_rcm_h006.msh``,
  KelvinVoigt + BernoulliSmoothMinSep with the leg's properties), psub 500
  then 1000 Ba, ``linear_stability(solver='banded', sigma=2*pi*120j,
  arnoldi_m=70, static_options={'linear_solver': 'btd'})`` with float64
  factors.  Stored per psub (suffix ``_500``, ``_1000``): the returned
  eigenvalues ``eigs``, their certificates ``res_rel``, ``n_conv``, the
  growth and frequency of the least-damped mode, the equilibrium's
  ``u_norm`` (2-norm of u) and the point's seconds on the CPU that made
  it (on an 8-core x86-64 CPU: 85.2 s, then 51.4 s).
- **small** (``tests/data/golden_hopf_small.npz``): the banded test models
  of ``tests/test_hopf.py:147-173`` (RCM vocal-fold mesh 8 x 4, psub 8000
  Ba): the equilibrium (u, q, p), the dense eigenvalues (``n_modes=12``),
  the banded f64 modes at ``sigma = 2*pi*f_dense*1j`` and at
  ``2*pi*130j`` (``arnoldi_m=60``) with their certificates.  About a
  minute.

- **dynamical** (``tests/data/golden_dynamical.npz``): the cases of
  ``tests/dynamical_cases.py`` (solid, fluid and coupled dynamical and
  linearized models on small meshes, inputs from seeded generators):
  under ``<case>/<assembly>`` each of ``assem_res``, ``assem_dres_dstate``,
  ``_dstatet``, ``_dcontrol`` and ``_dprop`` as one matrix
  (``to_mono_ndarray``) with its row and column labels as JSON under
  ``<case>/<assembly>/labels``; the solids' and the coupled model's banded
  blocks ``K``, ``D``, ``M`` and ``dp1_cols``
  (``assem_dresu_dp1_cols``); the coupled model's fluid area and solid
  pressure.  About 8 minutes on an 8-core CPU: the JAX package assembles
  these op by op.

The whole command took 11.5 minutes on an 8-core x86-64 CPU.  The
configuration of each Hopf run is stored as JSON under ``config``.  Not
collected by pytest (its name does not start with ``test_``); it imports
jax, so it is no part of the PyTorch port.
"""

import argparse
import json
import os
import time

import numpy as np

from make_golden_large_bsb import REPO, _jax

OUT_LARGE = os.path.join(REPO, "tests", "data", "golden_hopf_23k.npz")
OUT_SMALL = os.path.join(REPO, "tests", "data", "golden_hopf_small.npz")
OUT_DYNAMICAL = os.path.join(REPO, "tests", "data", "golden_dynamical.npz")
LARGE_MESH = os.path.join(REPO, "meshes", "M5_3layers_rcm_h006.msh")
PSUBS = (500.0, 1000.0)  # bench.py:562, 568
# bench.py:563-567
HOPF_ARGS = dict(solver="banded", sigma=1j * 2 * np.pi * 120.0, arnoldi_m=70,
                 static_options={"linear_solver": "btd"}, return_info=True)
# bench.py:548-558
LARGE_PROPS = dict(emod=5e4, rho=1.0, eta=3.0, nu=0.45, kcontact=1e8,
                   rho_air=1.1225e-3, zeta_min=1e-3, zeta_sep=1e-3)
# tests/test_hopf.py:160-170
SMALL_PROPS = dict(emod=3e4, rho=1.0, eta=2.0, kcontact=1e8, rho_air=1.1225e-3,
                   zeta_min=1e-3, zeta_sep=1e-3)
SMALL_PSUB = 8000.0
SMALL_SIGMA2 = 1j * 2 * np.pi * 130.0  # tests/test_hopf.py:216
SMALL_M = 60
SMALL_N_DENSE = 12


def build(mesh, props, model_type):
    """An FSI model of the JAX package with ``props``, the contact plane
    0.05 and the midline 0.01 above the mesh's top."""
    from vf_fem_tpu.load import load_fsi_model
    from vf_fem_tpu.residuals import fluid as flr, solid as slr

    ymax = mesh.coords[:, 1].max()
    m = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                       model_type=model_type)
    p = m.prop
    for k, v in props.items():
        p[k][:] = v
    p["ycontact"][:] = ymax + 0.05
    p["ymid"][:] = ymax + 0.01
    m.set_prop(p)
    return m


def large():
    jax = _jax()
    from vf_fem_tpu.mesh import load_gmsh
    from vf_fem_tpu.misc.hopf import growth_rate_and_frequency, linear_stability

    assert jax.config.jax_enable_x64

    mesh = load_gmsh(LARGE_MESH)
    tm, dm = build(mesh, LARGE_PROPS, "transient"), build(mesh, LARGE_PROPS, "dynamical")
    out = {}
    c = tm.control.copy()
    c["psup"][:] = 0.0
    for psub in PSUBS:
        c["psub"][:] = psub
        t0 = time.perf_counter()
        eigs, eq, info = linear_stability(tm, dm, c, tm.prop, device="cpu", **HOPF_ARGS)
        sec = time.perf_counter() - t0
        g, f = growth_rate_and_frequency(eigs)
        tag = f"_{int(psub)}"
        out.update({
            "eigs" + tag: np.asarray(eigs), "res_rel" + tag: np.asarray(info["res_rel"]),
            "n_conv" + tag: np.int64(info["n_conv"]), "growth" + tag: np.float64(g),
            "freq" + tag: np.float64(f),
            "u_norm" + tag: np.float64(np.linalg.norm(np.asarray(eq["u"]))),
            "seconds" + tag: np.float64(sec),
        })
        print(f"23.7k psub {psub:g}: {sec:.1f} s, growth {g:+.6f} 1/s, f {f:.6f} Hz,"
              f" n_conv {info['n_conv']}, cert max {info['res_rel'].max():.2e},"
              f" {len(eigs)} modes {np.round(eigs, 4).tolist()}", flush=True)
    config = {"mesh": os.path.relpath(LARGE_MESH, REPO), "psub": list(PSUBS),
              "props": LARGE_PROPS, "sigma_imag": HOPF_ARGS["sigma"].imag,
              "arnoldi_m": HOPF_ARGS["arnoldi_m"],
              "static_options": HOPF_ARGS["static_options"], "factor_dtype": "float64",
              "ndof": int(tm.solid.ndof)}
    np.savez_compressed(OUT_LARGE, config=json.dumps(config), **out)
    print("wrote", OUT_LARGE, flush=True)


def small():
    jax = _jax()
    from vf_fem_tpu.mesh import vocal_fold_mesh
    from vf_fem_tpu.mesh.reorder import rcm_mesh
    from vf_fem_tpu.misc.hopf import growth_rate_and_frequency, linear_stability

    assert jax.config.jax_enable_x64

    mesh = rcm_mesh(vocal_fold_mesh(8, 4))
    tm, dm = build(mesh, SMALL_PROPS, "transient"), build(mesh, SMALL_PROPS, "dynamical")
    c = tm.control.copy()
    c["psub"][:] = SMALL_PSUB
    c["psup"][:] = 0.0
    eigs_d, eq = linear_stability(tm, dm, c, tm.prop, n_modes=SMALL_N_DENSE)
    _, f_d = growth_rate_and_frequency(eigs_d)
    out = {"eq_u": np.asarray(eq["u"]), "eq_q": np.asarray(eq["q"]),
           "eq_p": np.asarray(eq["p"]), "dense": np.asarray(eigs_d)}
    for tag, sigma in (("fd", 1j * 2 * np.pi * f_d), ("130", SMALL_SIGMA2)):
        eigs, _, info = linear_stability(tm, dm, c, tm.prop, solver="banded", sigma=sigma,
                                         arnoldi_m=SMALL_M, return_info=True, device="cpu")
        out.update({f"banded_{tag}": np.asarray(eigs),
                    f"res_rel_{tag}": np.asarray(info["res_rel"]),
                    f"n_conv_{tag}": np.int64(info["n_conv"]),
                    f"sigma_{tag}": np.complex128(sigma)})
        print(f"small sigma {sigma:.4f}: {np.round(eigs, 6).tolist()}", flush=True)
    config = {"mesh": "rcm_mesh(vocal_fold_mesh(8, 4))", "psub": SMALL_PSUB,
              "props": SMALL_PROPS, "arnoldi_m": SMALL_M, "n_modes_dense": SMALL_N_DENSE}
    np.savez_compressed(OUT_SMALL, config=json.dumps(config), **out)
    print("wrote", OUT_SMALL, flush=True)


def dynamical():
    import dynamical_cases as dc

    jax = _jax()
    pkg = dc.jax_pkg()
    assert jax.config.jax_enable_x64
    out = {}
    t0 = time.perf_counter()
    for case, m in dc.cases(pkg).items():
        for which in dc.ASSEMBLIES:
            val = getattr(m, "assem_" + which)()
            out[f"{case}/{which}"] = val.to_mono_ndarray()
            labels = ([list(val.keys())] if which == "res"
                      else [list(x) for x in val.labels])
            out[f"{case}/{which}/labels"] = json.dumps(labels)
        solid = m.solid if hasattr(m, "solid") else m
        if case.startswith("solid_") and case != "solid_lin" or case == "fsi":
            _, K, D, M = solid.assem_banded_state_blocks()
            out.update({f"{case}/K": np.asarray(K), f"{case}/D": np.asarray(D),
                        f"{case}/M": np.asarray(M)})
            verts = (m.fsimap.dofs_solid if case == "fsi" else dc.dp1_verts(solid.nvert))
            out[f"{case}/dp1_verts"] = np.asarray(verts)
            out[f"{case}/dp1_cols"] = np.asarray(solid.assem_dresu_dp1_cols(verts))
        if case == "fsi":
            out["fsi/area"] = np.asarray(m.fluid.control["area"])
            out["fsi/solid_p"] = np.asarray(m.solid.control["p"])
        print(f"{case}: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(OUT_DYNAMICAL, **out)
    print("wrote", OUT_DYNAMICAL, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="the small Hopf golden only")
    ap.add_argument("--dynamical", action="store_true",
                    help="the dynamical models' golden only")
    args = ap.parse_args()
    if not args.small:
        dynamical()
    if not args.dynamical:
        small()
    if not (args.small or args.dynamical):
        large()


if __name__ == "__main__":
    main()
