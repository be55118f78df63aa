"""
The port's CUDA kernels on the card (``gpu`` marker; every test skips
without a CUDA device).  This file imports neither jax nor the JAX package,
so that it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import config, forward
from vf_fem_tpu_torch.fem import banded
from vf_fem_tpu_torch.mesh import load_gmsh

from port_fixtures import (
    MESHES, assert_scatter_close, port_inputs, port_vf_model,
)

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_fsi_explicit.npz")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["M5_3layers", "M5_3layers_rcm_h006"])
def plan(request, cuda):
    mesh = load_gmsh(os.path.join(MESHES, request.param + ".msh"))
    hp = banded.plan_banded(mesh.cells, mesh.num_vertices, gc=config.BANDED_GC)
    return banded.to_device(hp, cuda), mesh.num_vertices


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain(plan, dtype):
    """K1/K2 against the plain versions on the same inputs, for both offset
    patterns: the gather exactly, the scatter to summation order (rtol
    1e-13 in f64, 1e-6 in f32, or within the summation-order bound)."""
    dp, nvert = plan
    dev = dp.base.device
    rng = np.random.default_rng(0)
    F = torch.tensor(rng.standard_normal((11, nvert)), dtype=dtype, device=dev)
    loc = torch.tensor(rng.standard_normal((dp.nv, 11, dp.ncpad)), dtype=dtype,
                       device=dev)
    rtol = 1e-13 if dtype == torch.float64 else 1e-6
    n0 = dict(banded.LAUNCHES)
    for pattern in (dp.g, dp.s):
        torch.testing.assert_close(
            banded._gather(dp, F, pattern),
            banded.banded_gather_reference(dp, F, pattern), rtol=0, atol=0,
        )
        assert_scatter_close(
            banded._scatter(dp, loc, nvert, pattern),
            banded.banded_scatter_reference(dp, loc, nvert, pattern),
            banded.scatter_order_bound(dp, loc, nvert, pattern), rtol,
        )
    torch.cuda.synchronize()
    assert banded.LAUNCHES["gather"] == n0["gather"] + 2
    assert banded.LAUNCHES["scatter"] == n0["scatter"] + 2


def test_wrappers_reject_bad_input(plan):
    dp, nvert = plan
    dev = dp.base.device
    F = torch.zeros((4, nvert), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        banded.banded_gather(dp, F.T.contiguous().T)
    with pytest.raises(TypeError):
        banded.banded_gather(dp, F.to(torch.float16))
    with pytest.raises(ValueError, match="plan on"):
        banded.banded_gather(dp, F.cpu())


def test_explicit_golden_on_cuda(cuda):
    """The small explicit-FSI golden in f64 on the card, through K1/K2."""
    data = np.load(GOLDEN)
    model = port_vf_model(device=cuda)
    state0, cs, prop = port_inputs(model)
    banded.LAUNCHES.update(gather=0, scatter=0)
    fin, traj, infos = forward.integrate_pure(model, state0, cs, prop,
                                              data["times"])
    torch.cuda.synchronize()
    assert min(banded.LAUNCHES.values()) > 0
    np.testing.assert_allclose(
        traj["u"].cpu().numpy()[::8], data["u"], rtol=1e-8, atol=1e-12
    )
    np.testing.assert_allclose(traj["q"].cpu().numpy().ravel(), data["q"],
                               rtol=1e-8)
