"""
The port's linear stability analysis (``vf_fem_tpu_torch.misc.hopf``) on
the CPU in f64, on the banded test models of ``tests/test_hopf.py:147-173``
(RCM vocal-fold mesh 8 x 4, KelvinVoigt + BernoulliSmoothMinSep, psub 8000
Ba), against the JAX package's results in
``tests/data/golden_hopf_small.npz`` (``python tests/make_golden_hopf.py
--small``):

- the equilibrium (u, q, p) at rtol 1e-9;
- the dense solver's eigenvalues, each within 1e-8 max(|lambda|, 1) of the
  JAX dense solver's (and the other way round);
- the banded solver (f64 factors, sigma = 2 pi i f_dense, m 60): each
  returned mode within 1e-8 max(|lambda|, 1) of a mode the JAX banded
  solver returned, within ``tests/test_hopf.py:176-203``'s gates of the
  dense modes, and ``res_rel < 1e-6`` on the first four;
- float32 factors at ``tests/test_hopf.py:206-265``'s gates, unrefined
  and with the default refinement, against the f64 run at sigma = 2 pi i
  130;
- ``_filter_ritz`` on ``tests/test_hopf.py:16-57``'s cases;
- the band matvec of a complex vector (the plain version of K4, by its
  real and imaginary parts) against the JAX package's ``_np_band_matvec``.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.load import load_fsi_model
from vf_fem_tpu_torch.mesh import vocal_fold_mesh
from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
from vf_fem_tpu_torch.misc import hopf
from vf_fem_tpu_torch.misc.hopf import growth_rate_and_frequency, linear_stability
from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr
from vf_fem_tpu_torch.solvers import bsb

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_hopf_small.npz")
EIG_TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These solves are many small tensor ops, which run faster on one
    thread than split over a pool (the tier-1 run's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def models():
    """tests/test_hopf.py:147-173 in the port."""
    mesh = rcm_mesh(vocal_fold_mesh(8, 4))
    ymax = mesh.coords[:, 1].max()

    def make(model_type):
        m = load_fsi_model(mesh, slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                           model_type=model_type, device="cpu")
        p = m.prop
        for k, v in dict(emod=3e4, rho=1.0, eta=2.0, ycontact=ymax + 0.05, kcontact=1e8,
                         rho_air=1.1225e-3, zeta_min=1e-3, zeta_sep=1e-3,
                         ymid=ymax + 0.01).items():
            p[k][:] = v
        return m

    tm, dm = make("transient"), make("dynamical")
    c = {"psub": np.array([8000.0]), "psup": np.array([0.0])}
    return tm, dm, c


@pytest.fixture(scope="module")
def dense(models):
    tm, dm, c = models
    return linear_stability(tm, dm, c, tm.prop, n_modes=12)


def banded(models, sigma, **kw):
    tm, dm, c = models
    with warnings.catch_warnings():
        # pairs dropped by the certificate gate (as in the JAX package)
        warnings.simplefilter("ignore", RuntimeWarning)
        return linear_stability(tm, dm, c, tm.prop, solver="banded", sigma=sigma,
                                arnoldi_m=60, return_info=True, **kw)


def nearest(lam, ref, conj=False):
    """Distance of ``lam`` to the nearest of ``ref`` (or of their
    conjugates), relative to max(|lam|, 1)."""
    d = np.abs(ref - lam)
    if conj:
        d = np.minimum(d, np.abs(np.conj(ref) - lam))
    return d.min() / max(abs(lam), 1.0)


def test_equilibrium_matches_jax(golden, dense):
    _, eq = dense
    for k in ("u", "q", "p"):
        ref = golden["eq_" + k]
        np.testing.assert_allclose(eq[k], ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


def test_dense_matches_jax(golden, dense):
    eigs, _ = dense
    ref = golden["dense"]
    assert eigs.shape == ref.shape
    assert max(nearest(lam, ref) for lam in eigs) < EIG_TOL
    assert max(nearest(lam, eigs) for lam in ref) < EIG_TOL


@pytest.fixture(scope="module")
def banded_fd(models, golden):
    return banded(models, complex(golden["sigma_fd"]))


def test_banded_matches_jax(golden, models, banded_fd):
    eigs, _, info = banded_fd
    assert set(models[1].hopf_seconds) == {"static", "assembly", "factor", "w_columns",
                                           "arnoldi", "certificate"}
    ref = golden["banded_fd"]
    assert len(eigs) == len(ref) and info["n_conv"] == int(golden["n_conv_fd"])
    assert max(nearest(lam, ref) for lam in eigs) < EIG_TOL
    assert info["factor_dtype"] == "float64" and info["device"] == "cpu"
    assert info["refine"] == 0 and info["cert_tol"] == 1e-5 and info["arnoldi_m"] == 60
    assert set(info) == {"res_rel", "n_conv", "n_cert_dropped", "n_returned",
                         "factor_dtype", "device", "arnoldi_m", "cert_tol", "refine"}


def test_banded_matches_dense(dense, banded_fd):
    """tests/test_hopf.py:176-203's gates."""
    eigs_d, _ = dense
    eigs_b, _, info = banded_fd
    for lb in eigs_b[:4]:
        assert nearest(lb, eigs_d, conj=True) < 1e-5, (lb, eigs_d)
    sig_d, f_d = growth_rate_and_frequency(eigs_d)
    sig_b, f_b = growth_rate_and_frequency(eigs_b)
    np.testing.assert_allclose(sig_b, sig_d, rtol=1e-5)
    np.testing.assert_allclose(f_b, f_d, rtol=1e-6)
    assert np.all(info["res_rel"][:4] < 1e-6), info["res_rel"]


def test_banded_f32_factors_certified(models, golden):
    """tests/test_hopf.py:206-265's gates: float32 factors unrefined, and
    with the default refinement, against float64 ones."""
    sigma = 1j * 2 * np.pi * 130.0
    eigs64, _, info64 = banded(models, sigma)
    assert nearest(eigs64[0], golden["banded_130"]) < EIG_TOL
    s64, f64_ = growth_rate_and_frequency(eigs64)
    scale = abs(eigs64[0])
    assert np.all(info64["res_rel"] < info64["cert_tol"])
    assert np.all(info64["res_rel"][:4] < 1e-6), info64["res_rel"]

    eigs32, _, info32 = banded(models, sigma, factor_dtype="float32", refine=0)
    assert info32["factor_dtype"] == "float32" and info32["cert_tol"] == 2e-3
    assert np.all(info32["res_rel"] < info32["cert_tol"])
    s32, f32_ = growth_rate_and_frequency(eigs32)
    assert abs(s32 - s64) < 3e-3 * scale, (s32, s64)
    np.testing.assert_allclose(f32_, f64_, rtol=1e-3)

    eigs32r, _, info32r = banded(models, sigma, factor_dtype=np.float32)
    assert info32r["refine"] == 2 and info32r["cert_tol"] == 1e-5
    assert np.all(info32r["res_rel"] < 2e-6), info32r["res_rel"]
    assert info32r["res_rel"].min() < 1e-7, info32r["res_rel"]
    s32r, f32r_ = growth_rate_and_frequency(eigs32r)
    assert abs(s32r - s64) < 1e-5 * scale, (s32r, s64)
    np.testing.assert_allclose(f32r_, f64_, rtol=1e-5)


def test_banded_options_raise(models):
    tm, dm, c = models
    with pytest.raises(TypeError, match="does not accept banded-solver options"):
        linear_stability(tm, dm, c, tm.prop, refine=1)
    with pytest.raises(ValueError, match="factor_dtype"):
        banded(models, 1j * 2 * np.pi * 130.0, factor_dtype="bfloat16")


def test_ritz_filter_diagnostics():
    """tests/test_hopf.py:16-57 on the port's filter."""
    sigma = 1j * 2 * np.pi * 150.0
    theta = np.array([0.5 + 0.1j, -0.2 + 0.3j, 1e-14 + 0j])
    Y = np.eye(3, dtype=complex)
    with pytest.raises(RuntimeError, match="no Ritz pair converged"):
        hopf._filter_ritz(theta, Y, np.array([1.0, 1.0, 1.0]), 4, 30, sigma)
    with pytest.raises(RuntimeError, match="all Ritz values ~ 0"):
        hopf._filter_ritz(np.array([1e-14 + 0j]), Y[:, :1], np.array([1.0]), 4, 30, sigma)
    with pytest.warns(RuntimeWarning, match="only 1 of the requested 4"):
        lam, ysel = hopf._filter_ritz(theta, Y, np.array([1e-9, 1.0, 1.0]), 4, 30, sigma)
    np.testing.assert_allclose(lam, sigma - 1.0 / theta[0], rtol=1e-12)
    assert ysel.shape == (3, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lam, ysel = hopf._filter_ritz(theta, Y, np.array([1e-9, 1e-9, 0.0]), 2, 30, sigma)
    expect = sigma - 1.0 / theta[:2]
    order = np.argsort(-expect.real)
    np.testing.assert_allclose(lam, expect[order], rtol=1e-12)
    np.testing.assert_array_equal(ysel, Y[:, :2][:, order])


def test_band_matvec_matches_jax():
    """The complex band product of the certificate (K4's plain version on
    each part) against the JAX package's host mirror, with the padded tail
    block."""
    from vf_fem_tpu.misc.hopf import _np_band_matvec

    rng = np.random.default_rng(3)
    b, nblk, h, ndof = 128, 5, 2, 5 * 128 - 29
    nb = 2 * h + 1
    z = np.zeros(1, np.int32)
    plan = bsb.BSBPlan(ndof=ndof, b=b, nblk=nblk, nb=nb, h=h, tgt_idx=z,
                       src_keep=np.zeros(1, bool), bc_dofs=z[:0], diag_ones=z[:0])
    blocks = rng.standard_normal((nblk, nb, b, b))
    x = rng.standard_normal(ndof) + 1j * rng.standard_normal(ndof)
    tb = torch.as_tensor(blocks)
    y = (ops.bsb_matvec(plan, tb, torch.as_tensor(x.real.copy())).numpy()
         + 1j * ops.bsb_matvec(plan, tb, torch.as_tensor(x.imag.copy())).numpy())
    ref = _np_band_matvec(plan, blocks, x)
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_growth_rate_and_frequency():
    eigs = np.array([3.0 + 0j, -1.0 + 2 * np.pi * 100j, -2.0 - 2 * np.pi * 50j])
    assert growth_rate_and_frequency(eigs) == (-1.0, pytest.approx(100.0))
    assert growth_rate_and_frequency(np.array([-0.5 + 0j])) == (-0.5, 0.0)
