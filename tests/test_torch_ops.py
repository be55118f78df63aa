"""
The plain PyTorch versions of kernels K3, K4 and K5 (``vf_fem_tpu_torch.ops``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as ``tests/test_ops.py`` runs them, on the same numpy inputs.  On CPU
tensors the port's wrappers take the plain versions and launch nothing.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vf_fem_tpu.ops import ebe_matvec as jebe_matvec
from vf_fem_tpu.equations.newmark import newmark_predict_u as jnewmark_predict_u
from vf_fem_tpu.ops import newmark_update as jnewmark_update
from vf_fem_tpu.ops.pallas_kernels import bsb_matvec_pallas
from vf_fem_tpu.solvers import bsb as jbsb
from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.solvers import bsb as tbsb

# f64: the tolerance of tests/test_ops.py; f32: summation order and the
# coefficients' rounding
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors never reach a kernel."""
    before = dict(ops.LAUNCHES)
    yield
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ne", [37, 300])
def test_ebe_matvec_matches_pallas(ne, dtype):
    rng = np.random.default_rng(ne)
    nld, ndof = 6, 2 * ne
    J = rng.standard_normal((ne, nld, nld)).astype(dtype)
    x = rng.standard_normal(ndof).astype(dtype)
    dofs = rng.integers(0, ndof, size=(ne, nld))
    ref = np.asarray(jebe_matvec(jnp.asarray(J), jnp.asarray(x[dofs]), tile=16))
    y = ops.ebe_matvec(_t(J), _t(x), _t(dofs))
    assert y.dtype == _t(J).dtype and tuple(y.shape) == (ne, nld)
    np.testing.assert_allclose(y.numpy(), ref, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(ref).max())


def _synthetic_plan(nblk, h, ndof, b=128):
    """A block-banded plan of the JAX package's kind with no fill data
    (as tests/test_ops.py builds it), and the port's equal one."""
    kw = dict(
        ndof=ndof, b=b, nblk=nblk, nb=2 * h + 1, h=h,
        tgt_idx=np.zeros(1, np.int32), src_keep=np.ones(1, bool),
        bc_dofs=np.zeros(0, np.int32), diag_ones=np.zeros(0, np.int32),
    )
    return jbsb.BSBPlan(**kw), tbsb.BSBPlan(**kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "nblk,h,tail",
    [(3, 1, 17), (5, 2, 0), (4, 2, 100)],
    ids=["ragged17", "full", "ragged100"],
)
def test_bsb_matvec_matches_pallas(nblk, h, tail, dtype):
    """Including the ragged tail ``ndof = nblk * b - 17`` of
    tests/test_ops.py."""
    rng = np.random.default_rng(nblk * 10 + h)
    jplan, tplan = _synthetic_plan(nblk, h, nblk * 128 - tail)
    blocks = rng.standard_normal((nblk, 2 * h + 1, 128, 128)).astype(dtype)
    x = rng.standard_normal(tplan.ndof).astype(dtype)
    ref = np.asarray(bsb_matvec_pallas(jplan, jnp.asarray(blocks),
                                       jnp.asarray(x), tile=8))
    np.testing.assert_allclose(
        np.asarray(jbsb.bsb_matvec(jplan, jnp.asarray(blocks), jnp.asarray(x))),
        ref, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(ref).max(),
    )
    y = ops.bsb_matvec(tplan, _t(blocks), _t(x))
    assert tuple(y.shape) == (tplan.ndof,)
    np.testing.assert_allclose(y.numpy(), ref, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dt", [1e-4, 5e-5])
def test_newmark_update_matches_pallas(dt, dtype):
    """v1, a1 against the JAX package's Pallas kernel; the third output,
    the next step's predictor, against its ``newmark_predict_u`` of the
    JAX package's v1, a1."""
    rng = np.random.default_rng(123)
    u1, u0, v0, a0 = (rng.standard_normal(123).astype(dtype) for _ in range(4))
    jv, ja = jnewmark_update(*(jnp.asarray(a) for a in (u1, u0, v0, a0)), dt)
    ju = jnewmark_predict_u(jnp.asarray(u1), jv, ja, dt)
    outs = ops.newmark_update(*(_t(a) for a in (u1, u0, v0, a0)), dt)
    assert len(outs) == 3
    for out, ref in zip(outs, (jv, ja, ju)):
        ref = np.asarray(ref)
        assert out.dtype == _t(u1).dtype and tuple(out.shape) == (123,)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dt_next", [None, 7e-5])
def test_newmark_update_is_the_state_update(dt_next):
    """The plain K5 is the model's Newmark relations, bit for bit, and its
    third output the predictor of the next step (of ``dt_next``, by default
    ``dt``) from the rounded v1, a1."""
    from vf_fem_tpu_torch.equations import newmark

    rng = np.random.default_rng(7)
    u1, u0, v0, a0 = (_t(rng.standard_normal(50)) for _ in range(4))
    v1, a1, u_next = ops.newmark_update(u1, u0, v0, a0, 1e-4, dt_next=dt_next)
    torch.testing.assert_close(v1, newmark.newmark_v(u1, u0, v0, a0, 1e-4),
                               rtol=0, atol=0)
    torch.testing.assert_close(a1, newmark.newmark_a(u1, u0, v0, a0, 1e-4),
                               rtol=0, atol=0)
    dtp = 1e-4 if dt_next is None else dt_next
    assert torch.equal(u_next, newmark.newmark_predict_u(u1, v1, a1, dtp))
    assert all(torch.equal(x, y) for x, y in zip(
        ops.newmark_update_reference(u1, u0, v0, a0, 1e-4, dt_next=dt_next),
        (v1, a1, u_next)))


@pytest.mark.parametrize("dt", [1e-4, 3e-5])
def test_newmark_coefs_are_the_plain_expressions(dt):
    """K5's coefficient row (``equations.newmark.coefficients``, which the
    float API keeps as a device row) holds the scalars the plain version
    multiplies by, bit for bit."""
    from vf_fem_tpu_torch.equations import newmark
    from vf_fem_tpu_torch.ops import kernels

    gamma, beta, dtp = 0.5, 0.25, 0.9 * dt
    coefs = newmark.coefficients(dt, dtp, gamma, beta)
    row = kernels._newmark_row(torch.device("cpu"), torch.float64, dt, gamma, beta, dtp)
    assert row.dtype == torch.float64 and row.tolist() == list(coefs)
    row32 = kernels._newmark_row(torch.device("cpu"), torch.float32, dt, gamma, beta, dtp)
    assert row32.tolist() == [float(torch.tensor(c, dtype=torch.float32)) for c in coefs]
    # unit inputs pick each coefficient out of the plain version
    one = torch.ones(1, dtype=torch.float64)
    zero = torch.zeros(1, dtype=torch.float64)
    v1, a1, _ = ops.newmark_update_reference(one, zero, zero, zero, dt, gamma, beta)
    assert list(coefs) == [
        v1.item(),
        -ops.newmark_update_reference(zero, zero, one, zero, dt)[0].item(),
        -ops.newmark_update_reference(zero, zero, zero, one, dt)[0].item(),
        a1.item(),
        -ops.newmark_update_reference(zero, zero, zero, one, dt)[1].item(),
        dt, dtp, 0.5 * dtp * dtp,
    ]


def test_wrappers_reject_bad_input():
    x = torch.zeros(12, dtype=torch.float64)
    J = torch.zeros((2, 6, 6), dtype=torch.float64)
    dofs = torch.zeros((2, 6), dtype=torch.int64)
    with pytest.raises(TypeError):
        ops.ebe_matvec(J, x.float(), dofs)
    with pytest.raises(TypeError, match="int64"):
        ops.ebe_matvec(J, x, dofs.int())
    with pytest.raises(ValueError):
        ops.ebe_matvec(J, x, dofs[:1])
    _, tplan = _synthetic_plan(1, 0, 100)
    with pytest.raises(ValueError, match="blocks"):
        ops.bsb_matvec(tplan, torch.zeros((1, 1, 128, 64)), torch.zeros(100))
    with pytest.raises(TypeError):
        ops.newmark_update(x, x, x, x.to(torch.float16), 1e-4)
    with pytest.raises(ValueError):
        ops.newmark_update(x, x, x, x[:5], 1e-4)
    with pytest.raises(ValueError, match="tensors on"):
        ops.newmark_update(x, x, x, x.to("meta"), 1e-4)


def test_dot_order_bound_covers_reordering():
    """Summing the same products in the reverse order stays within the
    bound the card-side comparisons use."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        J = torch.tensor(rng.standard_normal((500, 6, 6)) * 1e3, dtype=dtype)
        x = torch.tensor(rng.standard_normal(400), dtype=dtype)
        dofs = torch.tensor(rng.integers(0, 400, size=(500, 6)))
        fwd = ops.ebe_matvec_reference(J, x, dofs)
        rev = ops.ebe_matvec_reference(J.flip(-1), x, dofs.flip(-1))
        bound = ops.dot_order_bound(
            ops.ebe_matvec_reference(J.abs(), x.abs(), dofs), 6
        )
        assert bool(((fwd - rev).abs() <= bound).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_bsb_csr_mm_is_the_matvec(dtype):
    """K4's library equivalent: ``sparse.mm`` on the CSR matrix of the
    plan's matvec pattern matches the plain matvec within the dot-product
    order bound (a ragged tail and exact zeros in the band included)."""
    from vf_fem_tpu_torch import yardsticks

    rng = np.random.default_rng(11)
    _, tplan = _synthetic_plan(4, 2, 4 * 128 - 100)
    blocks = rng.standard_normal((4, 5, 128, 128)).astype(dtype)
    blocks[rng.random(blocks.shape) < 0.7] = 0.0
    n, m, i, j = np.indices(blocks.shape)
    col = (n + m - 2) * 128 + j
    inside = (n * 128 + i < tplan.ndof) & (col >= 0) & (col < tplan.ndof)
    blocks[~inside] = 0.0
    # a pattern of the band's nonzeros and some of its zeros
    extra = inside & (rng.random(blocks.shape) < 0.01)
    tgt = np.flatnonzero((blocks != 0) | extra).astype(np.int32)
    tplan = tplan._replace(tgt_idx=tgt, src_keep=np.ones(tgt.size, bool))
    pattern = tbsb.MatvecPattern(*map(torch.as_tensor, tbsb.matvec_pattern(tplan)))
    B, x = _t(blocks), _t(rng.standard_normal(tplan.ndof).astype(dtype))
    csr = yardsticks.bsb_csr(tplan, B, pattern)
    assert csr.values().numel() == tgt.size
    out = yardsticks.csr_mm(csr, x).reshape(-1)
    ref = ops.bsb_matvec_reference(tplan, B, x)
    bound = ops.dot_order_bound(
        ops.bsb_matvec_reference(tplan, B.abs(), x.abs()), tplan.nb * 128)
    assert bool(((out - ref).abs() <= bound).all())
