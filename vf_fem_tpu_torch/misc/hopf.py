"""
Linear stability (Hopf) analysis of the coupled FSI system (counterpart
of ``vf_fem_tpu.misc.hopf``): find the coupled static configuration,
assemble the first-order Jacobians ``A = dF/dx`` and ``B = dF/dxt`` there,
and solve the generalized eigenproblem ``(A + lambda B) x = 0``.
Eigenvalues with ``Re(lambda) > 0`` mark phonation onset.

Two solvers:

- ``solver='dense'``: QZ on the dense blocks (M5 scale), assembled on the
  model's device; the QZ itself is ``scipy.linalg.eigvals`` on the host
  (torch has no generalized eigensolver).
- ``solver='banded'``: shift-invert Arnoldi at a large mesh.  The solid's
  pencil blocks ``K = dFu/du``, ``D = dFu/dv``, ``M = dFu/dvt`` are
  assembled banded; eliminating the trivial ``v`` rows and the small fluid
  block leaves, for each shift-invert action, one complex banded direct
  solve with ``K + sigma D + sigma^2 M`` (``solvers.cbtd``: two sweeps of
  the block-Thomas kernel K6 at twice the super-block width) and a
  rank-``n_fluid`` Woodbury correction for the coupling.  Everything runs
  on the device in float64/complex128: the band products of the
  right-hand side, of the refinement residual and of the eigenpair
  certificate are launches of the block-banded matvec kernel K4
  (``ops.bsb_matvec``) on the blocks as assembled, and the Arnoldi
  recurrence is on the device too.

:func:`linear_stability_banded` leaves each part's seconds in the
dynamical model's ``hopf_seconds`` (CUDA events on the card, the host
clock on the CPU; each part ends in a synchronization).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Optional

import numpy as np
import scipy.linalg as sla
import torch

from .. import config, ops, static
from ..models.dynamical import to_mono
from ..solvers import bsb, cbtd

__all__ = ["linear_stability", "linear_stability_banded", "dense_pencil",
           "qz_modes", "growth_rate_and_frequency"]

_FACTOR_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@contextlib.contextmanager
def _phase(seconds: dict, name: str, device: torch.device):
    """Add the seconds of the enclosed part to ``seconds[name]``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        yield
        sec = time.perf_counter() - t0
    seconds[name] = seconds.get(name, 0.0) + sec


def _linearization_point(transient_model, dyn_model, control, prop,
                         static_options=None):
    """The coupled equilibrium (Picard static solve of the transient
    model) and the dynamical model set to it; returns the equilibrium
    (dict of numpy arrays)."""
    eq_state, _ = static.static_coupled_configuration_picard(
        transient_model, control, prop, options=static_options)
    dyn_model.set_control(control)
    dyn_model.set_prop(prop)
    dyn_model.set_state({"u": eq_state["u"], "v": np.zeros_like(eq_state["u"]),
                         "q": eq_state["q"], "p": eq_state["p"]})
    dyn_model.set_statet({k: torch.zeros_like(v) for k, v in dyn_model.statet.items()})
    return eq_state


def linear_stability(
    transient_model,
    dyn_model,
    control,
    prop,
    n_modes: int = 8,
    solver: str = "dense",
    sigma: Optional[complex] = None,
    arnoldi_m: int = 80,
    static_options: Optional[dict] = None,
    **banded_kwargs,
):
    """The ``n_modes`` least-damped eigenvalues and the equilibrium.

    ``transient_model`` and ``dyn_model`` are the same coupled FSI
    configuration loaded as 'transient' and 'dynamical' models (the former
    gives the static solve, the latter the first-order Jacobians);
    ``control`` and ``prop`` are dicts of both.  ``solver`` is 'dense' (QZ)
    or 'banded' (:func:`linear_stability_banded`, which takes ``sigma``,
    ``arnoldi_m`` and ``banded_kwargs``).  ``static_options`` are the
    equilibrium solve's parameters (``{'linear_solver': 'btd'}`` at a large
    mesh).  Returns ``(eigvals, eq_state)``, the eigenvalues sorted by
    descending real part."""
    if solver == "banded":
        return linear_stability_banded(
            transient_model, dyn_model, control, prop, n_modes=n_modes,
            sigma=sigma, arnoldi_m=arnoldi_m, static_options=static_options,
            **banded_kwargs)
    if banded_kwargs:
        raise TypeError(
            "linear_stability(solver='dense') does not accept banded-"
            f"solver options {sorted(banded_kwargs)}")
    A, B, eq_state = dense_pencil(transient_model, dyn_model, control, prop,
                                  static_options)
    return qz_modes(A, B, n_modes), eq_state


def dense_pencil(transient_model, dyn_model, control, prop,
                 static_options: Optional[dict] = None):
    """The dense first-order pencil at the coupled equilibrium, ``(A, B,
    eq_state)``: ``A = dF/dx`` and ``B = dF/dxt`` assembled on the model's
    device with the Dirichlet rows applied, returned as host arrays for
    :func:`qz_modes` (the dense solver of :func:`linear_stability`)."""
    eq_state = _linearization_point(transient_model, dyn_model, control, prop,
                                    static_options)
    # F(x, xt) ~ A dx + B dxt = 0  ->  A v = -lambda B v
    A = to_mono(dyn_model.assem_dres_dstate())
    B = to_mono(dyn_model.assem_dres_dstatet())
    # Dirichlet rows: the dynamical Jacobians are assembled without BCs
    solid = dyn_model.solid
    bc = torch.as_tensor(solid.residual.bc_dofs, device=A.device)
    for off in (0, solid.ndof):  # u rows, v rows
        rows = bc + off
        A[rows, :] = 0.0
        A[rows, rows] = 1.0
        B[rows, :] = 0.0
    return A.cpu().numpy(), B.cpu().numpy(), eq_state


def qz_modes(A: np.ndarray, B: np.ndarray, n_modes: int = 8) -> np.ndarray:
    """The ``n_modes`` eigenvalues of ``A v = -lambda B v`` with the largest
    real parts, by QZ on the host.  B is singular (the quasi-steady fluid's
    rows are algebraic), so some eigenvalues are infinite: they are
    dropped."""
    w = sla.eigvals(A, -B)
    w = w[np.isfinite(w)]
    return w[np.argsort(-w.real)][:n_modes]


def _filter_ritz(theta, Y, resid, n_modes, arnoldi_m, sigma):
    """Keep the converged shift-invert Ritz pairs and map them back to
    eigenvalues ``lam = sigma - 1/theta``: ``(lam, Ysel)``, every converged
    eigenvalue by descending real part and its Ritz-vector coefficients.
    The caller truncates to ``n_modes`` after the certificate gate.  An
    unconverged ``theta ~ 0`` maps to a huge spurious eigenvalue, hence the
    filter.  Raises when nothing converged; warns when fewer than
    ``n_modes`` did."""
    keep = np.abs(theta) > 1e-12
    theta, Y, resid = theta[keep], Y[:, keep], resid[keep]
    conv = (resid / np.abs(theta)) < 1e-6
    n_conv = int(conv.sum())
    if n_conv == 0:
        best = (f"{float((resid / np.abs(theta)).min()):.1e}"
                if theta.size else "n/a (all Ritz values ~ 0)")
        raise RuntimeError(
            "linear_stability(banded): no Ritz pair converged"
            f" (best rel residual {best}"
            f" over {theta.size} values, arnoldi_m={arnoldi_m},"
            f" sigma={sigma}) — raise arnoldi_m or move the shift"
            " closer to the expected mode")
    if n_conv < n_modes:
        warnings.warn(
            f"linear_stability(banded): only {n_conv} of the"
            f" requested {n_modes} modes converged"
            f" (arnoldi_m={arnoldi_m}); the returned spectrum is"
            " the least-damped CONVERGED modes — raise arnoldi_m"
            " for the full set",
            RuntimeWarning)
    lam = sigma - 1.0 / theta[conv]
    Ysel = Y[:, conv]
    order = np.argsort(-lam.real)
    return lam[order], Ysel[:, order]


def _factor_dtype(factor_dtype) -> torch.dtype:
    if factor_dtype is None:
        return torch.float64
    if isinstance(factor_dtype, str):
        name = factor_dtype
    elif isinstance(factor_dtype, torch.dtype):
        name = str(factor_dtype).replace("torch.", "")
    else:
        name = np.dtype(factor_dtype).name
    if name not in _FACTOR_DTYPES:
        raise ValueError(f"linear_stability(banded): factor_dtype {factor_dtype!r}"
                         f" not supported ({tuple(_FACTOR_DTYPES)})")
    return _FACTOR_DTYPES[name]


def linear_stability_banded(
    transient_model,
    dyn_model,
    control,
    prop,
    n_modes: int = 8,
    sigma: Optional[complex] = None,
    arnoldi_m: int = 80,
    static_options: Optional[dict] = None,
    device=None,
    factor_dtype=None,
    refine: Optional[int] = None,
    cert_tol: Optional[float] = None,
    return_info: bool = False,
):
    """Shift-invert Arnoldi on the banded Hopf pencil (large mesh).

    Finds the ``n_modes`` eigenvalues of ``A x = -lambda B x`` nearest the
    shift ``sigma`` (default ``2*pi*150j``): each Arnoldi step applies ``x
    -> (A + sigma B)^{-1} B x``, whose Ritz values ``theta`` map back as
    ``lambda = sigma - 1/theta``.

    ``device``: where the factors, solves and recurrence run (default the
    model's device).  ``factor_dtype``: the factors' dtype, 'float64'
    (default) or 'float32'; the right-hand side ``B x``, the refinement
    residual and the recurrence stay float64/complex128.  ``refine``:
    iterative-refinement passes a shift-invert action, the residual against
    the shifted coupled operator in float64 through K4 on the blocks as
    assembled, the correction through the same factors (default 0 for
    float64 factors, 2 for float32).  ``cert_tol``: the eigenpair-residual
    gate; Ritz pairs whose certificate ``||(A + lam B) x|| / scale`` (K4
    on the blocks as assembled, independent of the factors) exceeds it are
    dropped with a warning before the ``n_modes`` truncation (default 1e-5
    for float64 factors and refined (refine >= 2) float32 ones, 1e-4 at
    refine 1, 2e-3 unrefined).  ``return_info``: also return a dict with
    the certificates ``res_rel``, ``n_conv`` (converged Ritz pairs before
    the gate), ``n_cert_dropped``, ``n_returned``, ``factor_dtype``,
    ``device``, ``arnoldi_m``, ``cert_tol`` and ``refine``.

    Returns ``(eigvals, eq_state)`` or ``(eigvals, eq_state, info)``; the
    seconds of each part ('static', 'assembly', 'factor', 'w_columns',
    'arnoldi', 'certificate') are left in ``dyn_model.hopf_seconds``.
    """
    if sigma is None:
        sigma = 1j * 2.0 * np.pi * 150.0
    sigma = complex(sigma)
    sr, si = sigma.real, sigma.imag
    solid, fluid = dyn_model.solid, dyn_model.fluid
    dev = solid.device if device is None else config.model_device(device)
    wp = _factor_dtype(factor_dtype)
    f64, c128 = torch.float64, torch.complex128
    seconds = dyn_model.hopf_seconds = {}

    with _phase(seconds, "static", dev):
        eq_state = _linearization_point(transient_model, dyn_model, control, prop,
                                        static_options)
    ndof, dim = solid.ndof, solid.dim
    fsimap = dyn_model.fsimap

    # -- the pencil's blocks and the small dense coupling pieces -------------
    with _phase(seconds, "assembly", dev):
        # the static solve's plan of the mesh (the transient solid's), so a
        # point builds and holds one plan
        tplan = transient_model.solid.bsb_plan()
        plan, Kb, Db, Mb = solid.assem_banded_state_blocks(tplan)
        fill = tplan[1] if dev == solid.device else bsb.fill_plan(plan, dev)
        Kb, Db, Mb = (x.to(device=dev, dtype=f64) for x in (Kb, Db, Mb))
        nq = fluid.state["q"].numel()
        nf = nq + fluid.state["p"].numel()
        Ff = to_mono(fluid.assem_dres_dstate()).to(device=dev, dtype=f64)  # (nf, nf)
        dfl_dctrl = fluid.assem_dres_dcontrol()
        vs, vf = fsimap.dofs_solid, fsimap.dofs_fluid
        ydofs = torch.as_tensor(vs * dim + 1, device=dev)
        vf_t = torch.as_tensor(vf, device=dev)
        # G = dFfluid/du: columns only at the interface y dofs
        # (area_j = 2*(ymid - y_j): d(area)/d(u_y) = -2)
        G_cols = torch.cat([dfl_dctrl["q", "area"].to(dev, f64)[:, vf_t],
                            dfl_dctrl["p", "area"].to(dev, f64)[:, vf_t]]) * (-2.0)
        # C = dFu/dp_fluid at the interface columns
        C_f = torch.zeros((ndof, nf), dtype=f64, device=dev)
        C_f[:, nq + vf_t] = solid.assem_dresu_dp1_cols(vs).to(dev, f64)
        FfI = torch.linalg.inv(Ff)
        U_w = C_f @ FfI  # (ndof, nf)
        bcmask = torch.ones(ndof, dtype=f64, device=dev)
        bcmask[torch.as_tensor(solid.residual.bc_dofs, device=dev)] = 0.0
        # the complex shifted band Kz = K + sigma D + sigma^2 M, and D + sr M
        blocks_re = Kb + sr * Db + (sr * sr - si * si) * Mb
        blocks_im = si * Db + 2.0 * sr * si * Mb
        DsM = Db + sr * Mb
    G_c, C_c, Ff_c, FfI_c, U_c = (a.to(c128) for a in (G_cols, C_f, Ff, FfI, U_w))
    bcmask_c = bcmask.to(c128)

    def mv(blocks, x):
        """The band product of a real vector: one K4 launch on the card."""
        return ops.bsb_matvec(plan, blocks, x, fill.pattern)

    def cmv(blocks, z):
        """The band product of a complex vector: its two real parts."""
        return torch.complex(mv(blocks, z.real.contiguous()),
                             mv(blocks, z.imag.contiguous()))

    # -- the factors and the coupling solves W = Kz^-1 U_w ------------------
    with _phase(seconds, "factor", dev):
        # factored in float64 (Hopper has f64 LU at the f32 vector rate),
        # stored in the factors' dtype, which is what the sweeps read.  An
        # f32 LU of the embedded Schur complements (condition ~5e6 on the
        # test mesh) leaves the unrefined modes at the mercy of its
        # rounding: tests/hopf_f32_spread.py
        facz = cbtd.cbtd_factor(plan, blocks_re, blocks_im)
        if wp != f64:
            facz = facz._replace(Sinv=facz.Sinv.to(wp), V=facz.V.to(wp),
                                 W=facz.W.to(wp), d=facz.d.to(wp))
    with _phase(seconds, "w_columns", dev):
        UwT = U_w.T.to(wp).contiguous()  # (nf, ndof)
        zero = torch.zeros(ndof, dtype=wp, device=dev)
        cols = [cbtd.cbtd_solve(plan, facz, UwT[j], zero) for j in range(nf)]
        WrT = torch.stack([c[0] for c in cols])
        WiT = torch.stack([c[1] for c in cols])
        # the Woodbury capacitance (I - G W), nf x nf
        Wy = torch.complex(WrT[:, ydofs].to(f64), WiT[:, ydofs].to(f64))
        Scap = torch.eye(nf, dtype=c128, device=dev) - G_c @ Wy.T
        ScapI = torch.linalg.inv(Scap)
    Gc_w = G_cols.to(wp)
    ScapIr, ScapIi = ScapI.real.to(wp), ScapI.imag.to(wp)

    if refine is None:
        refine = 0 if wp == f64 else 2

    def solve_coupled(b_r, b_i):
        """(Kz - U_w G~)^{-1} b: the block-Thomas solve and the rank-nf
        Woodbury correction, in the factors' dtype."""
        y0r, y0i = cbtd.cbtd_solve(plan, facz, b_r, b_i)
        t_r = Gc_w @ y0r[ydofs]
        t_i = Gc_w @ y0i[ydofs]
        s_r = ScapIr @ t_r - ScapIi @ t_i
        s_i = ScapIr @ t_i + ScapIi @ t_r
        return y0r + s_r @ WrT - s_i @ WiT, y0i + s_i @ WrT + s_r @ WiT

    def op(x):
        """The shift-invert action ``(A + sigma B)^{-1} B x``."""
        xu, xv = x[:ndof], x[ndof:2 * ndof]
        rv = -(bcmask_c * xu)
        # b = M xv - (D + sigma M) rv, complex128, by K4 on the blocks
        Mrv = cmv(Mb, rv)
        b = cmv(Mb, xv) - (cmv(DsM, rv) + 1j * si * Mrv)
        # the factors' solve and float64 iterative refinement
        u = torch.zeros(ndof, dtype=c128, device=dev)
        r = b
        for k in range(refine + 1):
            d_r, d_i = solve_coupled(r.real.to(wp), r.imag.to(wp))
            u = u + torch.complex(d_r.to(f64), d_i.to(f64))
            if k == refine:
                break
            ur, ui = u.real.contiguous(), u.imag.contiguous()
            Ku = torch.complex(mv(blocks_re, ur) - mv(blocks_im, ui),
                               mv(blocks_re, ui) + mv(blocks_im, ur))
            r = b - Ku + U_c @ (G_c @ u[ydofs])
        # back-substitution: v, then the fluid block
        v = rv + sigma * (bcmask_c * u)
        f = -(FfI_c @ (G_c @ u[ydofs]))
        return torch.cat([u, v, f])

    # -- Arnoldi (complex128, on the device) ---------------------------------
    with _phase(seconds, "arnoldi", dev):
        n = 2 * ndof + nf
        rng = np.random.default_rng(0)
        v0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        bc_np = bcmask.cpu().numpy()
        v0[:ndof] *= bc_np
        v0[ndof:2 * ndof] *= bc_np
        v0 /= np.linalg.norm(v0)
        m = min(arnoldi_m, n - 1)
        V = torch.zeros((m + 1, n), dtype=c128, device=dev)
        H = torch.zeros((m + 1, m), dtype=c128, device=dev)
        V[0] = torch.as_tensor(v0, device=dev)
        for k in range(m):
            w = op(V[k])
            # modified Gram-Schmidt, one reorthogonalization pass
            for _ in range(2):
                for i in range(k + 1):
                    hik = torch.vdot(V[i], w)
                    H[i, k] += hik
                    w -= hik * V[i]
            hk = torch.linalg.vector_norm(w)
            H[k + 1, k] = hk
            if float(hk) < 1e-12:
                m = k + 1
                break
            V[k + 1] = w / hk
        Hh = H.cpu().numpy()
    theta, Y = np.linalg.eig(Hh[:m, :m])
    # Ritz residuals: |h_{m+1,m} y_m| bounds the shift-invert eigen-
    # residual; relative to |theta| the Ritz pair's backward error
    h_last = np.abs(Hh[m, m - 1]) if m <= Hh.shape[0] - 1 else 0.0
    resid = h_last * np.abs(Y[-1, :])
    lam, Ysel = _filter_ritz(theta, Y, resid, n_modes, arnoldi_m, sigma)

    # -- the eigenpair-residual certificate ----------------------------------
    # ||(A + lam B) x|| against the blocks as assembled, independent of the
    # factors, so an inexact shift-invert action is caught, not trusted
    with _phase(seconds, "certificate", dev):
        X = V[:m].T @ torch.as_tensor(Ysel, device=dev)
        res_rel = np.zeros(len(lam))
        norm = torch.linalg.vector_norm
        for j, lj in enumerate(lam):
            lj = complex(lj)
            x = X[:, j] / norm(X[:, j])
            u, v, f = x[:ndof], x[ndof:2 * ndof], x[2 * ndof:]
            Ku, Dv, Mv = cmv(Kb, u), cmv(Db, v), cmv(Mb, v)
            Cf = C_c @ f
            r_u = Ku + Dv + lj * Mv + Cf
            r_v = v - lj * (bcmask_c * u)
            Gu = G_c @ u[ydofs]
            Fff = Ff_c @ f
            r_f = Fff + Gu
            num = torch.sqrt(torch.sum(torch.abs(r_u) ** 2) + torch.sum(torch.abs(r_v) ** 2)
                             + torch.sum(torch.abs(r_f) ** 2))
            den = (norm(Ku) + norm(Dv) + abs(lj) * norm(Mv) + norm(Cf) + norm(v)
                   + abs(lj) * norm(u) + norm(Fff) + norm(Gu) + 1e-300)
            res_rel[j] = float(num / den)

    wp_name = str(wp).replace("torch.", "")
    if cert_tol is None:
        if wp == f64 or refine >= 2:
            cert_tol = 1e-5
        elif refine == 1:
            cert_tol = 1e-4
        else:
            cert_tol = 2e-3
    n_conv_ritz = len(lam)  # converged Ritz pairs, before the gate
    keep = res_rel < cert_tol
    if not np.any(keep):
        raise RuntimeError(
            "linear_stability(banded): every converged Ritz pair FAILED"
            f" the independent eigenpair-residual certificate (best"
            f" {res_rel.min():.1e} vs cert_tol {cert_tol:.1e};"
            f" factor_dtype {wp_name}) — the shift-invert factor precision is"
            " insufficient at this conditioning; use f64 factors"
            " or move the shift closer to the target modes")
    if not np.all(keep):
        warnings.warn(
            f"linear_stability(banded): dropped {int((~keep).sum())} of"
            f" {len(lam)} converged Ritz pairs whose eigenpair residual"
            f" exceeded cert_tol={cert_tol:.1e} (inexact"
            f" {wp_name}-factor shift-invert artifacts); {int(keep.sum())}"
            " certified modes remain",
            RuntimeWarning)
    lam, res_rel = lam[keep][:n_modes], res_rel[keep][:n_modes]
    if return_info:
        info = {
            "res_rel": res_rel,
            "n_conv": n_conv_ritz,
            "n_cert_dropped": n_conv_ritz - int(keep.sum()),
            "n_returned": len(lam),
            "factor_dtype": wp_name,
            "device": str(dev),
            "arnoldi_m": m,
            "cert_tol": cert_tol,
            "refine": refine,
        }
        return lam, eq_state, info
    return lam, eq_state


def growth_rate_and_frequency(eigvals: np.ndarray):
    """(growth rate, frequency in Hz) of the least-damped oscillatory
    mode."""
    osc = eigvals[np.abs(eigvals.imag) > 1e-6]
    if len(osc) == 0:
        return float(eigvals[0].real), 0.0
    lead = osc[np.argmax(osc.real)]
    return float(lead.real), float(abs(lead.imag) / (2 * np.pi))
