"""
K6's cluster design on the CPU: the launch plans of K6 and K6T
(``ops.sweep_plan``, ``ops.sweep_t_plan``) for every row-block width and
dtype pair, and the emulation of
the cluster schedule (``sweep_emulation.emulate_sweep``: row ownership,
ring slots, the lane/chunk order and xor tree of each row, the buffer
parity of the exchange) against the plain sweep ``ops.btd_sweep_reference``.
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.ops import kernels

from sweep_emulation import emulate_sweep

PAIRS = {
    "bf16-f64": (torch.bfloat16, torch.float64),
    "bf16-f32": (torch.bfloat16, torch.float32),
    "f64-f64": (torch.float64, torch.float64),
    "f32-f32": (torch.float32, torch.float32),
}


@pytest.mark.parametrize("bt", kernels.SWEEP_WIDTHS)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_sweep_plan_fits(pair, bt):
    """The rows divide among the CTAs, the ring slots divide a CTA's rows,
    a warp pushes whole 32-bit words, and the ring, the two buffers of the
    carried vector and the mbarriers fit in 232,448 bytes."""
    fdt, vdt = PAIRS[pair]
    p = ops.sweep_plan(bt, fdt, vdt)
    es = fdt.itemsize
    assert p.rows_per_cta * p.cluster == bt
    assert p.stage_rows * p.stages_per_block == p.rows_per_cta
    assert p.warps * p.rows_per_warp == p.stage_rows and 1 <= p.warps <= 16
    assert p.rows_per_warp * es % 4 == 0
    assert 2 <= p.ring <= 16
    assert p.smem_bytes == (p.ring * p.stage_rows * bt * es + 2 * bt * es
                            + (2 * 16 + 2) * 8)
    assert p.smem_bytes <= kernels.SMEM_LIMIT == 232448
    assert p.threads == (p.warps + 1) * 32 <= 1024


@pytest.mark.parametrize("bt", kernels.SWEEP_T_WIDTHS)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_sweep_t_plan_fits(pair, bt):
    """K6T's plan: K6's cluster; the columns divide among the CTAs, a
    consumer warp reads one 16-byte chunk of every box row (up to Bt = 512;
    an equal share of at most 16 warps at 1280), a ring slot
    holds at most 256 box rows (whole lanes' worth) in tensor-map boxes of
    a swizzle span (128, 64 or 32 bytes) that divides a box row, each box
    a whole number of the swizzle's 1024-byte periods, and the ring, the
    two buffers of the carried vector, the mbarriers and 1024 bytes of
    alignment fit in 232,448 bytes."""
    fdt, vdt = PAIRS[pair]
    p = ops.sweep_t_plan(bt, fdt, vdt)
    es = fdt.itemsize
    row_bytes = p.cols_per_cta * es
    assert p.cluster == ops.sweep_plan(bt, fdt, vdt).cluster
    assert p.cols_per_cta * p.cluster == bt
    assert row_bytes % (16 * p.warps) == 0 and 1 <= p.warps <= 16
    assert p.warps * 16 == row_bytes or bt == 1280
    assert p.stage_rows * p.stages_per_block == bt
    assert p.stage_rows % 32 == 0 and p.stage_rows <= 256
    assert p.box_bytes in (32, 64, 128) and row_bytes % p.box_bytes == 0
    assert row_bytes % (2 * p.box_bytes) != 0 or p.box_bytes == 128
    assert p.stage_rows * p.box_bytes % 1024 == 0
    assert 2 <= p.ring <= 16
    assert p.smem_bytes == (1024 + p.ring * p.stage_rows * row_bytes + 2 * bt * es
                            + (2 * 16 + 2) * 8)
    assert p.smem_bytes <= kernels.SMEM_LIMIT == 232448
    assert p.threads == (p.warps + 1) * 32 <= 1024


@pytest.mark.parametrize("pair", list(PAIRS))
def test_sweep_plan_default_cluster(pair):
    """16 CTAs for f64 factors, 8 otherwise, at every width (the
    ``cluster_size`` of ``csrc/cluster.cuh``)."""
    fdt, vdt = PAIRS[pair]
    want = 16 if fdt == torch.float64 else 8
    assert kernels.SWEEP_CLUSTER[fdt] == want
    assert {ops.sweep_plan(bt, fdt, vdt).cluster for bt in kernels.SWEEP_WIDTHS} == {want}


def test_sweep_plan_3d_width():
    """At the 3D width (Bt = 1280) every pair keeps a ring of two slots: f64
    factors take 10 warps of one row (16 would leave one slot of 160 KB),
    the others 16 warps.  K6T is built there too: 10 consumer warps of 2
    (bf16) or 4 (f32, f64) 16-byte chunks, 352 threads (at most 1,024),
    stages of 128 box rows (at most 256, the TMA's box limit) in five
    boxes, and a ring of 5 slots of 40 KB (bf16) or 2 of 80 KB, all within
    232,448 bytes."""
    for pair, (warps, ring) in {"bf16-f64": (16, 2), "bf16-f32": (16, 2),
                                "f64-f64": (10, 2), "f32-f32": (16, 2)}.items():
        p = ops.sweep_plan(1280, *PAIRS[pair])
        assert (p.warps, p.ring) == (warps, ring), pair
    for pair, (cluster, box, ring) in {"bf16-f64": (8, 64, 5), "bf16-f32": (8, 64, 5),
                                       "f64-f64": (16, 128, 2),
                                       "f32-f32": (8, 128, 2)}.items():
        fdt, vdt = PAIRS[pair]
        p = ops.sweep_t_plan(1280, fdt, vdt)
        row_bytes = p.cols_per_cta * fdt.itemsize
        assert (p.cluster, p.warps, p.stage_rows, p.box_bytes, p.ring) == (
            cluster, 10, 128, box, ring), pair
        assert row_bytes // 16 // p.warps == (2 if fdt == torch.bfloat16 else 4), pair
        assert row_bytes // p.box_bytes == 5, pair
        assert p.threads == 352 <= 1024 and p.ring >= 2 and p.stage_rows <= 256
        assert p.smem_bytes == (1024 + p.ring * p.stage_rows * row_bytes + 2 * 1280 * fdt.itemsize
                                + (2 * 16 + 2) * 8) <= 232448, pair


def test_sweep_plan_rejects():
    with pytest.raises(ValueError, match="row blocks"):
        ops.sweep_plan(16, torch.bfloat16, torch.float64)
    with pytest.raises(TypeError):
        ops.sweep_plan(256, torch.float16, torch.float64)
    with pytest.raises(TypeError):
        ops.sweep_plan(256, torch.float64, torch.float32)


def exact_inputs(n, bt, fdt, vdt, seed):
    """Factors and right-hand sides on which every order of every dot
    product gives the same sum: A_i is nonzero only on rows and columns of
    the parity of i (small integers), so A_i reads only entries of the
    carried vector that A_{i-1} left at g_{i-1} (small integers, exact in
    bf16), and every partial sum is an integer below 2^24."""
    rng = np.random.default_rng(seed)
    A = rng.integers(-4, 5, size=(n, bt, bt)).astype(np.float64)
    k = np.arange(bt)
    for i in range(n):
        off = (k % 2) != (i % 2)
        A[i][off, :] = 0.0
        A[i][:, off] = 0.0
    g = rng.integers(-16, 17, size=(n, bt)).astype(np.float64)
    return torch.as_tensor(A).to(fdt), torch.as_tensor(g).to(vdt)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("bt", [128, 256])
@pytest.mark.parametrize("n", [1, 2, 93])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_emulation_bit_equal_to_plain(pair, n, bt, reverse):
    """The cluster schedule reproduces the plain sweep bit for bit at
    Bt = 128 and 256 (two ring slots a row block for f32 factors) on inputs
    whose sums are exact in any order (so only a wrong row, slot or buffer
    can differ), and the plain sweep through ``ops.btd_sweep`` on CPU
    tensors launches nothing."""
    fdt, vdt = PAIRS[pair]
    A, g = exact_inputs(n, bt, fdt, vdt, seed=n)
    before = dict(ops.LAUNCHES)
    ref = ops.btd_sweep(A, g, reverse=reverse)
    assert ops.LAUNCHES == before
    out = emulate_sweep(A, g, reverse)
    assert torch.equal(out, ref)
    if n > 1:  # the carried vector matters: not the trivial sweep y = g
        assert not torch.equal(ref, g)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_emulation_bit_equal_to_plain_3d_width(pair, reverse):
    """The same at the 3D width, Bt = 1280 (five to ten ring slots a row
    block, two in the ring), over 3 row blocks."""
    fdt, vdt = PAIRS[pair]
    A, g = exact_inputs(3, 1280, fdt, vdt, seed=5)
    ref = ops.btd_sweep(A, g, reverse=reverse)
    assert torch.equal(emulate_sweep(A, g, reverse), ref)
    assert not torch.equal(ref, g)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_emulation_rows_on_random_factors(pair):
    """On random factors scaled to 0.5/sqrt(Bt) (a bounded recurrence), each
    emulated row is the plain row from the emulation's own previous row,
    within the dot-product order bound (rtol 1e-13 f64, 1e-6 f32), at
    Bt = 256 over 9 row blocks (two ring slots a block for f64 factors)."""
    fdt, vdt = PAIRS[pair]
    rng = np.random.default_rng(7)
    bt, n = 256, 9
    A = torch.as_tensor(rng.standard_normal((n, bt, bt)) * (0.5 / bt ** 0.5)).to(fdt)
    g = torch.as_tensor(rng.standard_normal((n, bt))).to(vdt)
    rtol = 1e-13 if vdt == torch.float64 else 1e-6
    for rev in (False, True):
        out = emulate_sweep(A, g, rev)
        ref, bound = ops.btd_sweep_rows_reference(A, g, out, rev)
        assert bool(((out - ref).abs() <= rtol * ref.abs() + bound).all())
