"""
Banded gather/scatter (K1/K2) of the port against the JAX package's
(``vf_fem_tpu.fem.banded``, interpret-mode Pallas on the CPU), in f64.

On the CPU the port's wrappers run their plain PyTorch versions; the
CUDA kernels' index arithmetic (the CSR transpose the scatter kernel sums
over) is checked here by a numpy emulation of the kernel loops.  The
kernels themselves are held against the plain versions on the card by
``test_torch_cuda.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vf_fem_tpu.fem import banded as jbanded
from vf_fem_tpu.mesh import load_gmsh as jload_gmsh, vocal_fold_mesh
from vf_fem_tpu.mesh.reorder import rcm_mesh
from vf_fem_tpu_torch.fem import banded as tbanded

from port_fixtures import MESHES, assert_scatter_close

# (plan source, channel count C): the small RCM mesh at the test suite's
# group size, and the M5-3layers mesh at the port's (C = 11 on the
# KelvinVoigtWEpithelium cell pass)
CASES = [("rcm_small", 5), ("M5_3layers", 11)]


def _bound(case, terms, pattern):
    return tbanded.scatter_order_bound(
        case["dp"], torch.from_numpy(terms), case["nvert"], pattern
    )


def _plans(source):
    if source == "rcm_small":
        m = rcm_mesh(vocal_fold_mesh(12, 6))
        gc = 128
    else:
        m = jload_gmsh(os.path.join(MESHES, source + ".msh"))
        gc = 256
    cells = np.asarray(m.cells)
    jp = jbanded.plan_banded(cells, m.num_vertices, gc=gc)
    tp = tbanded.plan_banded(cells, m.num_vertices, gc=gc)
    return jp, tp, m.num_vertices


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    source, C = request.param
    jp, tp, nvert = _plans(source)
    dp = tbanded.to_device(tp, "cpu")
    rng = np.random.default_rng(0)
    return dict(
        jp=jp, tp=tp, dp=dp, nvert=nvert, C=C,
        F=rng.standard_normal((C, nvert)),
        loc=rng.standard_normal((dp.nv, C, dp.ncpad)),
        ct_rows=rng.standard_normal((C, nvert)),
    )


def test_gather_exact(case):
    out = tbanded.banded_gather(case["dp"], torch.from_numpy(case["F"]))
    ref = jbanded.banded_gather(case["jp"], jnp.asarray(case["F"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_scatter_matches(case):
    out = tbanded.banded_scatter(
        case["dp"], torch.from_numpy(case["loc"]), case["nvert"]
    )
    ref = jbanded.banded_scatter(case["jp"], jnp.asarray(case["loc"]), case["nvert"])
    assert_scatter_close(
        out, np.asarray(ref), _bound(case, case["loc"], case["dp"].s), 1e-13
    )


def test_gather_vjp_matches_jax(case):
    F = torch.from_numpy(case["F"]).requires_grad_()
    (g,) = torch.autograd.grad(
        tbanded.banded_gather(case["dp"], F), F, torch.from_numpy(case["loc"])
    )
    _, vjp = jax.vjp(lambda x: jbanded.banded_gather(case["jp"], x),
                     jnp.asarray(case["F"]))
    (ref,) = vjp(jnp.asarray(case["loc"]))
    assert_scatter_close(
        g, np.asarray(ref), _bound(case, case["loc"], case["dp"].g), 1e-13
    )


def test_scatter_vjp_matches_jax(case):
    loc = torch.from_numpy(case["loc"]).requires_grad_()
    out = tbanded.banded_scatter(case["dp"], loc, case["nvert"])
    (g,) = torch.autograd.grad(out, loc, torch.from_numpy(case["ct_rows"]))
    _, vjp = jax.vjp(
        lambda x: jbanded.banded_scatter(case["jp"], x, case["nvert"]),
        jnp.asarray(case["loc"]),
    )
    (ref,) = vjp(jnp.asarray(case["ct_rows"]))
    # the scatter's VJP is a gather: exact copies
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref))


def test_gradcheck_plain_pair():
    _, tp, nvert = _plans("rcm_small")
    dp = tbanded.to_device(tp, "cpu")
    rng = np.random.default_rng(1)
    F = torch.from_numpy(rng.standard_normal((2, nvert))).requires_grad_()
    loc = torch.from_numpy(
        rng.standard_normal((dp.nv, 2, dp.ncpad))
    ).requires_grad_()
    assert torch.autograd.gradcheck(lambda x: tbanded.banded_gather(dp, x), (F,))
    assert torch.autograd.gradcheck(
        lambda x: tbanded.banded_scatter(dp, x, nvert), (loc,)
    )


def test_padding_rules(case):
    dp, nvert = case["dp"], case["nvert"]
    ncells = case["jp"].ncells
    if ncells == dp.ncpad:
        pytest.skip("plan has no padding slots")
    # padded slots never contribute to the scatter, whatever they hold
    loc = torch.from_numpy(case["loc"].copy())
    clean = loc.clone()
    clean[:, :, ncells:] = 0.0
    loc[:, :, ncells:] = float("nan")
    out = tbanded.banded_scatter(dp, loc, nvert)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(
        out.numpy(), tbanded.banded_scatter(dp, clean, nvert).numpy()
    )
    # the scatter's transpose reads zero where delta == w ...
    ct = torch.from_numpy(case["ct_rows"])
    g = tbanded.banded_gather_reference(dp, ct, dp.s)
    assert (g[:, :, ncells:] == 0).all()
    # ... while the gather duplicates a real cell into the padding
    g = tbanded.banded_gather(dp, ct)
    assert (g[:, :, ncells:] == g[:, :, ncells - 1 : ncells]).all()


def _emulate_scatter_kernel(dp, pattern, loc, n_out):
    """The CUDA scatter kernel's loop, in numpy."""
    ptr, idx = pattern.ptr.numpy(), pattern.idx.numpy()
    nv, C, ncpad = loc.shape
    out = np.zeros((C, n_out))
    for n in range(n_out):
        for k in range(ptr[n], ptr[n + 1]):
            v, cell = divmod(int(idx[k]), ncpad)
            out[:, n] += loc[v, :, cell]
    return out


def _emulate_gather_kernel(dp, pattern, F):
    """The CUDA gather kernel's indexing, in numpy."""
    C, nF = F.shape
    base, delta = dp.base.numpy(), pattern.delta.numpy()
    cell = np.arange(dp.ncpad)
    g, j = cell // dp.gc, cell % dp.gc
    out = np.zeros((dp.nv, C, dp.ncpad))
    for v in range(dp.nv):
        d = delta[g, v, j]
        col = base[g] + d
        ok = (d < dp.w) & (col < nF)
        out[v][:, ok] = F[:, col[ok]]
    return out


@pytest.mark.parametrize("which", ["g", "s"])
def test_kernel_index_arithmetic(case, which):
    """Sequential CSR sums in (slot, group, cell) order reproduce the plain
    ``index_add_`` scatter bit for bit; the gather indexing is exact."""
    dp, nvert = case["dp"], case["nvert"]
    pattern = getattr(dp, which)
    ref = tbanded.banded_scatter_reference(
        dp, torch.from_numpy(case["loc"]), nvert, pattern
    ).numpy()
    np.testing.assert_array_equal(
        _emulate_scatter_kernel(dp, pattern, case["loc"], nvert), ref
    )
    ref = tbanded.banded_gather_reference(
        dp, torch.from_numpy(case["F"]), pattern
    ).numpy()
    np.testing.assert_array_equal(
        _emulate_gather_kernel(dp, pattern, case["F"]), ref
    )
