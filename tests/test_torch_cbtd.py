"""
The port's complex block-tridiagonal solver (``vf_fem_tpu_torch.solvers.
cbtd``: the 2x real embedding, factored by the block-Thomas loop it shares
with ``solvers.btd``, solved by two sweeps of K6's plain version on the
CPU) against the JAX package's ``solvers.cbtd`` in f64, on seeded complex
banded systems (numpy generator) of blocks of 128:

- the factors (``Sinv``, ``V``, ``W``, ``d``) and the solution against the
  JAX package's at rtol 1e-12 (atol 1e-12 times the largest entry);
- the solution against a dense complex solve at rtol 1e-10;
- half-band 1 and 2, the latter with a pad super-block (``nblk`` not a
  multiple of ``h``), both with a partial last block (``ndof`` not a
  multiple of ``b``);
- float32 blocks factored in float32 (the JAX package's float32
  arithmetic, equilibration included): the factors against the JAX
  package's float32 factors, and both packages' solutions against the
  dense float64 solve, at rtol 1e-5;
- an embedded width that K6 is not built for raises, naming it;
- ``btd_factor`` through the shared Thomas loop: the same factors as the
  JAX package's ``btd_factor``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu.solvers import bsb as jbsb, btd as jbtd, cbtd as jcbtd
from vf_fem_tpu_torch.solvers import bsb, btd, cbtd

from port_fixtures import band_blocks, bare_plan, complex_band_system

B = 128
# (h, nblk, ndof): h = 1, and h = 2 with a pad super-block (5 = 2*3 - 1)
SYSTEMS = {"h1": (1, 4, 4 * B - 37), "h2_pad": (2, 5, 5 * B - 11)}


def _plan(cls, h, nblk, ndof):
    return bare_plan(cls, h, nblk, ndof, B)


def _dense(h, nblk, ndof, blocks):
    """The (ndof, ndof) matrix of band blocks (block row n, block column
    n + m - h)."""
    A = np.zeros((nblk * B, nblk * B), dtype=blocks.dtype)
    for n in range(nblk):
        for m in range(2 * h + 1):
            c = n + m - h
            if 0 <= c < nblk:
                A[n * B:(n + 1) * B, c * B:(c + 1) * B] = blocks[n, m]
    return A[:ndof, :ndof]


def _system(h, nblk, ndof, seed):
    return complex_band_system(h, nblk, ndof, seed, B)


@pytest.fixture(scope="module", params=list(SYSTEMS))
def case(request):
    h, nblk, ndof = SYSTEMS[request.param]
    blocks, A, r = _system(h, nblk, ndof, seed=7 + h)
    np.testing.assert_array_equal(_dense(h, nblk, ndof, blocks), A)
    plan = _plan(bsb.BSBPlan, h, nblk, ndof)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    fac = cbtd.cbtd_factor(plan, t(blocks.real), t(blocks.imag))
    x = cbtd.cbtd_solve(plan, fac, t(r.real), t(r.imag))
    jplan = _plan(jbsb.BSBPlan, h, nblk, ndof)
    jfac = jcbtd.cbtd_factor(jplan, jnp.asarray(blocks.real), jnp.asarray(blocks.imag))
    jx = jcbtd.cbtd_solve(jplan, jfac, jnp.asarray(r.real), jnp.asarray(r.imag))
    return dict(A=A, r=r, fac=fac, x=x, jfac=jfac, jx=jx, plan=plan)


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_factors_match_jax(case):
    fac, jfac = case["fac"], case["jfac"]
    assert fac.Bt == jfac.Bt and fac.Sinv.shape[1] == 2 * fac.Bt
    for name in ("Sinv", "V", "W", "d"):
        _close(getattr(fac, name).numpy(), getattr(jfac, name), 1e-12)


def test_solution_matches_jax_and_dense(case):
    x = case["x"][0].numpy() + 1j * case["x"][1].numpy()
    jx = np.asarray(case["jx"][0]) + 1j * np.asarray(case["jx"][1])
    _close(x, jx, 1e-12)
    _close(x, np.linalg.solve(case["A"], case["r"]), 1e-10)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_f32_factors_match_jax(name):
    """The float32 factorization of both packages on the same float32
    blocks: the same factors to float32 accuracy, and solutions as close
    to the float64 one."""
    h, nblk, ndof = SYSTEMS[name]
    blocks, A, r = _system(h, nblk, ndof, seed=7 + h)
    x = np.linalg.solve(A, r)
    f32 = [np.ascontiguousarray(a, dtype=np.float32)
           for a in (blocks.real, blocks.imag, r.real, r.imag)]
    plan = _plan(bsb.BSBPlan, h, nblk, ndof)
    fac = cbtd.cbtd_factor(plan, torch.as_tensor(f32[0]), torch.as_tensor(f32[1]))
    assert fac.Sinv.dtype == torch.float32
    xr, xi = cbtd.cbtd_solve(plan, fac, torch.as_tensor(f32[2]), torch.as_tensor(f32[3]))
    jplan = _plan(jbsb.BSBPlan, h, nblk, ndof)
    jfac = jcbtd.cbtd_factor(jplan, jnp.asarray(f32[0]), jnp.asarray(f32[1]))
    jx = jcbtd.cbtd_solve(jplan, jfac, jnp.asarray(f32[2]), jnp.asarray(f32[3]))
    for k in ("Sinv", "V", "W", "d"):
        _close(getattr(fac, k).double().numpy(), np.asarray(getattr(jfac, k), np.float64), 1e-5)
    _close(xr.double().numpy() + 1j * xi.double().numpy(), x, 1e-5)
    _close(np.asarray(jx[0], np.float64) + 1j * np.asarray(jx[1], np.float64), x, 1e-5)


def test_pad_super_block():
    """h = 2 over 5 block rows: the third super-row holds one real block
    row and one identity pad row, embedded as [[I, -I], [I, I]]."""
    h, nblk, ndof = SYSTEMS["h2_pad"]
    n_sup = -(-nblk // h)
    assert n_sup * h > nblk
    blocks, A, r = _system(h, nblk, ndof, seed=3)
    plan = _plan(bsb.BSBPlan, h, nblk, ndof)
    fac = cbtd.cbtd_factor(plan, torch.as_tensor(blocks.real.copy()),
                           torch.as_tensor(blocks.imag.copy()))
    assert fac.Sinv.shape == (n_sup, 2 * h * B, 2 * h * B)
    xr, xi = cbtd.cbtd_solve(plan, fac, torch.as_tensor(r.real.copy()),
                             torch.as_tensor(r.imag.copy()))
    _close(xr.numpy() + 1j * xi.numpy(), np.linalg.solve(A, r), 1e-10)


@pytest.mark.parametrize("h, b", [(3, 128), (1, 32)])
def test_width_without_kernel_raises(h, b):
    nblk = 4
    plan = bare_plan(bsb.BSBPlan, h, nblk, nblk * b, b)
    blocks = torch.zeros((nblk, 2 * h + 1, b, b), dtype=torch.float64)
    with pytest.raises(ValueError, match=f"2\\*h\\*b = {2 * h * b}"):
        cbtd.cbtd_factor(plan, blocks, blocks)


def test_btd_factor_through_shared_loop():
    """``btd_factor`` (its serial loop now ``btd.thomas_factor``) against
    the JAX package's on a real system of h = 2 with a pad super-block."""
    h, nblk, ndof = SYSTEMS["h2_pad"]
    blocks, A, r = _system(h, nblk, ndof, seed=5)
    blocks, A, r = blocks.real.copy(), A.real, r.real
    A += np.diag(np.abs(np.diag(A)))  # keep the real part dominant
    blocks = band_blocks(h, nblk, ndof, A, B)
    plan = _plan(bsb.BSBPlan, h, nblk, ndof)
    fac = btd.btd_factor(plan, torch.as_tensor(blocks))
    jfac = jbtd.btd_factor(_plan(jbsb.BSBPlan, h, nblk, ndof), jnp.asarray(blocks))
    for name in ("Sinv", "V", "W", "d"):
        _close(getattr(fac, name).numpy(), getattr(jfac, name), 1e-12)
    x = btd.btd_solve(plan, fac, torch.as_tensor(r))
    _close(x.numpy(), np.linalg.solve(A, r), 1e-10)
