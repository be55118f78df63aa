"""
Banded gather/scatter (K1/K2) of the port against the JAX package's
(``vf_fem_tpu.fem.banded``, interpret-mode Pallas on the CPU), in f64.

On the CPU the port's wrappers run their plain PyTorch versions; the
CUDA kernels' staging and index arithmetic (the gather's windows, the
scatter's tiles and the CSR transpose it sums over, the channel chunks) is
checked here by a numpy emulation of the kernels, and the one-call library equivalents
(``vf_fem_tpu_torch.yardsticks``) against the plain versions.  The
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
from vf_fem_tpu_torch import yardsticks
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


def _probe_modes():
    """Each way of calling ``fn(x)``, with whether ``x`` is differentiated
    inside it."""
    from torch.autograd import forward_ad as fwAD
    from torch.func import grad, jacfwd, jvp, vjp

    def plain(fn, x):
        with torch.no_grad():
            fn(x)

    def autograd(fn, x):
        fn(x.clone().requires_grad_())

    def forward_ad(fn, x):
        with fwAD.dual_level():
            fn(fwAD.make_dual(x, torch.ones_like(x)))

    return {
        "plain": (plain, False),
        "no_grad_mode": (lambda fn, x: plain(fn, x.clone().requires_grad_()), False),
        "autograd": (autograd, True),
        "forward_ad": (forward_ad, True),
        "func_grad": (lambda fn, x: grad(lambda y: fn(y).sum())(x), True),
        "func_vjp": (lambda fn, x: vjp(fn, x), True),
        "func_jvp": (lambda fn, x: jvp(fn, (x,), (torch.ones_like(x),)), True),
        "func_jacfwd": (lambda fn, x: jacfwd(fn)(x), True),
    }


@pytest.mark.parametrize("mode", list(_probe_modes()))
def test_differentiated_probe(mode):
    """``banded_gather``/``banded_scatter`` take their autograd Function
    exactly when their input is differentiated, under every mode the port
    uses (the probe reads only public queries)."""
    call, expected = _probe_modes()[mode]
    seen = []

    def fn(x):
        seen.append(tbanded._differentiated(x))
        return x * 2.0

    call(fn, torch.ones(3, dtype=torch.float64))
    assert seen == [expected]


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
    """The CUDA scatter kernel, in numpy: CTA (tile, channel c) stages the
    rows loc[v, c, g*gc : (g+1)*gc] of groups glo .. glo + ngt - 1 as its
    slab, then each row of the tile sums its CSR entries from the slab
    through ``lidx``, in CSR order."""
    ptr, lidx = pattern.ptr.numpy(), pattern.lidx.numpy()
    glo, ngt = pattern.glo.numpy(), pattern.ngt.numpy()
    nv, C, ncpad = loc.shape
    grouped = loc.reshape(nv, C, dp.ngroups, dp.gc)
    out = np.full((C, n_out), np.nan)
    for t in range(-(-n_out // tbanded.SCATTER_TILE)):
        rows = range(t * tbanded.SCATTER_TILE,
                     min(n_out, (t + 1) * tbanded.SCATTER_TILE))
        for c in range(C):
            # (ngt, nv, gc): group-major, then slot, then cell
            slab = grouped[:, c, glo[t] : glo[t] + ngt[t]].transpose(1, 0, 2).ravel()
            for n in rows:
                acc = 0.0
                for k in range(ptr[n], ptr[n + 1]):
                    acc += slab[lidx[k]]
                out[c, n] = acc
    return out


def _emulate_gather_kernel(dp, pattern, F, cpb):
    """The CUDA gather kernel, in numpy: CTA (group g, chunk of ``cpb``
    channels) stages the window F[c, base_g : base_g + w] of its channels
    (zero past F's columns), then thread (v, j) copies its chunk's channels
    from the window at its offset, zero at delta == w."""
    C, nF = F.shape
    base, delta = dp.base.numpy(), pattern.delta.numpy()
    Fp = np.concatenate([F, np.zeros((C, dp.nvert_pad - nF))], axis=1)
    out = np.full((dp.nv, C, dp.ncpad), np.nan)
    for g in range(dp.ngroups):
        for c0 in range(0, C, cpb):
            chans = slice(c0, min(C, c0 + cpb))
            win = Fp[chans, base[g] : base[g] + dp.w]
            d = delta[g]  # (nv, gc)
            vals = np.where(d < dp.w, win[:, np.minimum(d, dp.w - 1)], 0.0)
            out[:, chans, g * dp.gc : (g + 1) * dp.gc] = vals.transpose(1, 0, 2)
    return out


@pytest.mark.parametrize("which", ["g", "s"])
def test_kernel_index_arithmetic(case, which):
    """The kernels' staging and index arithmetic, emulated: the scatter's
    sums over its staged slabs reproduce the plain ``index_add_`` scatter
    bit for bit (the same order); the gather from its staged windows is
    exact for several channel chunks, narrow F included."""
    dp, nvert, C = case["dp"], case["nvert"], case["C"]
    pattern = getattr(dp, which)
    ref = tbanded.banded_scatter_reference(
        dp, torch.from_numpy(case["loc"]), nvert, pattern
    ).numpy()
    np.testing.assert_array_equal(
        _emulate_scatter_kernel(dp, pattern, case["loc"], nvert), ref
    )
    for n_cols in (nvert, nvert - 37):
        F = case["F"][:, :n_cols]
        ref = tbanded.banded_gather_reference(
            dp, torch.from_numpy(F), pattern
        ).numpy()
        for cpb in (1, 2, C):
            np.testing.assert_array_equal(
                _emulate_gather_kernel(dp, pattern, F, cpb), ref
            )


@pytest.mark.parametrize("which", ["g", "s"])
def test_scatter_tiles(case, which):
    """The scatter's host-built tile arrays: every CSR entry's group lies
    in its tile's staged range, its slab offset decodes back to the entry,
    and ``max_ngt`` bounds every tile."""
    dp = case["dp"]
    pattern = getattr(dp, which)
    ptr, idx = pattern.ptr.numpy(), pattern.idx.numpy().astype(np.int64)
    lidx = pattern.lidx.numpy().astype(np.int64)
    glo, ngt = pattern.glo.numpy(), pattern.ngt.numpy()
    tile = np.repeat(np.arange(dp.nvert_pad), np.diff(ptr)) // tbanded.SCATTER_TILE
    assert len(glo) == len(ngt) == -(-dp.nvert_pad // tbanded.SCATTER_TILE)
    v, cell = idx // dp.ncpad, idx % dp.ncpad
    g, j = cell // dp.gc, cell % dp.gc
    assert ((g >= glo[tile]) & (g < glo[tile] + ngt[tile])).all()
    gi, rest = np.divmod(lidx, dp.nv * dp.gc)
    np.testing.assert_array_equal(glo[tile] + gi, g)
    np.testing.assert_array_equal(rest, v * dp.gc + j)
    assert pattern.max_ngt == ngt.max() and (ngt >= 0).all()
    assert pattern.max_ngt <= dp.ngroups


@pytest.mark.parametrize("C", [1, 2, 5, 11])
@pytest.mark.parametrize("ngroups", [1, 4, 47, 92, 300])
def test_channels_per_cta(C, ngroups):
    """The gather's channel chunks cover every channel; a group's channels
    are split no further than needed for its CTAs to cover the card, and
    far enough that a CTA's window and mbarriers fit its shared memory."""
    for chan_bytes in (3072, 16_384, 100_000):
        cpb = tbanded.channels_per_cta(C, ngroups, chan_bytes)
        chunks = -(-C // cpb)
        assert 1 <= cpb <= C and chunks * cpb >= C
        assert cpb * (chan_bytes + 8) + 16 <= tbanded._SMEM
        if C * (chan_bytes + 8) + 16 <= tbanded._SMEM:
            if ngroups >= tbanded._SMS:  # one CTA per group
                assert cpb == C
            if ngroups * C <= tbanded._SMS:  # one CTA per (group, channel)
                assert cpb == 1
            # no more chunks than the card needs
            assert ngroups * (chunks - 1) < tbanded._SMS
