"""
The port's numpy mesh code and banded plan against the JAX package's:
gmsh loading, the 1D fluid interface and ``plan_banded``.
"""

import os

import numpy as np
import pytest

from vf_fem_tpu import mesh as jmesh
from vf_fem_tpu.fem import banded as jbanded
from vf_fem_tpu.mesh.reorder import rcm_mesh
from vf_fem_tpu_torch import mesh as tmesh
from vf_fem_tpu_torch.fem import banded as tbanded

from port_fixtures import MESHES

MSH = ["M5_3layers.msh", "M5_CB_GA3.msh"]


@pytest.fixture(scope="module", params=MSH)
def mesh_pair(request):
    path = os.path.join(MESHES, request.param)
    return jmesh.load_gmsh(path), tmesh.load_gmsh(path)


def _marked_facets(m):
    """{(sorted vertex tuple, marker)} of the facets with a nonzero marker
    (facet numbering may differ between the two packages)."""
    mf = m.mesh_functions[m.dim - 1]
    ids = np.nonzero(mf)[0]
    return {(tuple(sorted(m.facets[i].tolist())), int(mf[i])) for i in ids}


def test_load_gmsh_matches(mesh_pair):
    jm, tm = mesh_pair
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    for d in (0, jm.dim):
        np.testing.assert_array_equal(tm.mesh_functions[d], jm.mesh_functions[d])
    assert tm.subdomains == jm.subdomains
    assert _marked_facets(tm) == _marked_facets(jm)
    bset = lambda m: {tuple(sorted(m.facets[i].tolist())) for i in m.boundary_facets}
    assert bset(tm) == bset(jm)


def test_fluid_interface_matches(mesh_pair):
    jm, tm = mesh_pair
    for a, b in zip(
        tmesh.derive_1d_interface(tm), jmesh.derive_1d_interface(jm)
    ):
        np.testing.assert_array_equal(a, b)


def _small_rcm():
    """RCM-ordered, cell-sorted ``vocal_fold_mesh(12, 6)`` (built with the
    JAX package; the port takes its arrays)."""
    m = rcm_mesh(jmesh.vocal_fold_mesh(12, 6))
    return m.cells, m.num_vertices


def _msh_cells(name):
    m = tmesh.load_gmsh(os.path.join(MESHES, name))
    return m.cells, m.num_vertices


@pytest.mark.parametrize("gc", [128, 256])
@pytest.mark.parametrize("source", ["rcm_small", *MSH])
def test_plan_banded_identical(source, gc):
    cells, nvert = _small_rcm() if source == "rcm_small" else _msh_cells(source)
    jp = jbanded.plan_banded(np.asarray(cells), nvert, gc=gc)
    tp = tbanded.plan_banded(np.asarray(cells), nvert, gc=gc)
    for f in ("ngroups", "gc", "nv", "w", "nvert_pad", "ncells"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("base", "delta_g", "delta_s", "cells_pad"):
        a, b = getattr(tp, f), getattr(jp, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_plan_banded_rejects_unordered_mesh():
    m = tmesh.vocal_fold_mesh(24, 12)
    cells = np.asarray(m.cells).copy()
    np.random.default_rng(0).shuffle(cells)
    with pytest.raises(ValueError, match="not bandwidth-ordered"):
        tbanded.plan_banded(cells, m.num_vertices, gc=128, max_window=128)
