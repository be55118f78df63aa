"""
The kernels of a batch of variants on the block direct solvers, on the CPU
(their plain versions): the ``torch.func.vmap`` rules of K6 and K6T
(``ops.btd_sweep`` / ``ops.btd_sweep_t``), which fold the batch axis onto
the chain axis of one launch, over 4-D factors (a batch of chains) and 5-D
ones (a batch of SPIKE slabs), bit for bit the plain sweeps over slabs;
the launch plan of K5T over a batch (``ops.newmark_t_batch_ctas``: one CTA
a variant at M5's 960 dofs, several at 23,754); and the solvers a batch
refuses, by name.
"""

import numpy as np
import pytest
import torch
from torch.func import vmap

from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.models.transient import BATCH_SOLVERS, _batch_params

PAIRS = [(torch.bfloat16, torch.float64), (torch.float64, torch.float64),
         (torch.float32, torch.float32), (torch.float8_e4m3fn, torch.float64)]
PAIR_IDS = ["bf16-f64", "f64", "f32", "e4m3-f64"]


BT = 32  # the plain versions take any width (the kernels' are SWEEP_WIDTHS)


def _inputs(shape, fdt, vdt, seed):
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.standard_normal(shape + (BT, BT)) * 0.1).to(fdt)
    g = torch.tensor(rng.standard_normal(shape + (BT,))).to(vdt)
    return A, g


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("transpose", [False, True], ids=["K6", "K6T"])
@pytest.mark.parametrize("rank", [4, 5], ids=["chains", "slabs"])
def test_vmap_rule_is_the_slab_sweep(pair, transpose, rank):
    """``vmap`` of a sweep over (B, n, Bt, Bt) factors (B chains) and over
    (B, S, n, Bt, Bt) ones (B S slabs) is the plain sweep over the folded
    slabs, bit for bit, both directions; so is the sweep of the leading
    axes themselves."""
    fdt, vdt = pair
    shape = (3, 5) if rank == 4 else (3, 2, 5)
    A, g = _inputs(shape, fdt, vdt, seed=rank)
    sweep = ops.btd_sweep_t if transpose else ops.btd_sweep
    ref_fn = ops.btd_sweep_t_slabs_reference if transpose else ops.btd_sweep_slabs_reference
    for rev in (False, True):
        got = vmap(sweep, in_dims=(0, 0, None))(A, g, rev)
        ref = ref_fn(A.reshape(-1, 5, BT, BT), g.reshape(-1, 5, BT), rev).reshape(g.shape)
        assert torch.equal(got, ref)
        assert torch.equal(sweep(A, g, reverse=rev), ref)


def test_vmap_rule_takes_unbatched_factors():
    """A batch of vectors under one set of factors (``in_dims`` None for
    the factors): each variant's sweep on the shared factors."""
    A, g = _inputs((4,), torch.float64, torch.float64, seed=1)
    gb = torch.stack([g, 2 * g, -g])
    got = vmap(ops.btd_sweep, in_dims=(None, 0))(A, gb)
    for b in range(3):
        assert torch.equal(got[b], ops.btd_sweep(A, gb[b]))


def test_vmap_rule_moves_the_batch_axis():
    """A batch axis that is not the first (``in_dims`` 1) is moved first."""
    A, g = _inputs((3, 4), torch.float64, torch.float64, seed=2)
    got = vmap(ops.btd_sweep_t, in_dims=(1, 1))(A.movedim(0, 1), g.movedim(0, 1))
    assert torch.equal(got, ops.btd_sweep_t(A, g))


@pytest.mark.parametrize("batch, n, sms, ctas", [
    (8, 960, 132, 1), (64, 960, 132, 1), (256, 960, 132, 1),
    (8, 23754, 132, 16), (4, 23754, 132, 23), (16, 23754, 132, 8),
    (64, 23754, 132, 2), (256, 23754, 132, 1), (8, 2048, 132, 2), (1, 45816, 114, 44),
])
def test_newmark_t_batch_plan(batch, n, sms, ctas):
    """K5T over a batch: one CTA a variant at M5's 960 dofs whatever the
    batch (phase 19's ``sweep_grad`` keeps its results), several at large
    n, each taking at least ``NEWMARK_T_BATCH_ENTRIES`` entries, the batch's
    CTAs within the card's SMs and one slot's partial sums."""
    got = ops.newmark_t_batch_ctas(batch, n, sms)
    assert got == ctas
    if got > 1:
        assert batch * got <= min(sms, ops.kernels.NEWMARK_T_MAX_CTAS)
        assert n / got >= ops.kernels.NEWMARK_T_BATCH_ENTRIES


def test_newmark_t_batch_ctas_on_the_cpu():
    """On CPU tensors a batched K5T with any plan is the plain version."""
    rng = np.random.default_rng(4)
    vecs = [torch.as_tensor(rng.standard_normal((3, 3000))) for _ in range(6)]
    row = ops.newmark_row(ops.kernels.newmark.coefficients(1e-4, 2e-4), torch.float64, "cpu")
    ref = ops.newmark_update_t_batch_reference(*vecs, row)
    for ctas in (None, 1, 3):
        got = ops.newmark_update_t_batch(*vecs, row, ctas=ctas)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("solver", ["cg", "bsb"])
def test_batch_refuses_krylov_solvers(solver):
    """A batch steps with the dense and the block direct solvers; the
    Krylov ones raise, naming the solver."""
    assert BATCH_SOLVERS == ("dense", "btd", "spike")
    for ok in BATCH_SOLVERS:
        assert _batch_params({"linear_solver": ok})["linear_solver"] == ok
    with pytest.raises(NotImplementedError, match=repr(solver)):
        _batch_params({"linear_solver": solver})
