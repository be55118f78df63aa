"""
The port's M5 mesher (``mesh.m5``, ``triangulate``, ``step_io``,
``_m5_data``: the numpy path of the JAX package's) and its gmsh writer:

- ``m5_mesh`` at h = 0.04 for ``M5_3layers`` and ``M5_CB_GA3`` equals the
  JAX package's with its native kernels switched off
  (``VF_FEM_TPU_NATIVE=0``): coordinates, cells, facets and every marker
  and group name, exactly;
- against the JAX package's native path (C++ point-in-polygon, distance
  and facet hashing, where a compiler builds it): coordinates within 1e-12
  cm, the same cells, and each facet group the same set of vertex pairs
  (the native facet table is ordered differently);
- ``write_gmsh`` then ``load_gmsh`` gives the same mesh back.
"""

import numpy as np
import pytest

from vf_fem_tpu_torch.mesh import load_gmsh, m5_mesh, m5_profile_names, write_gmsh

PROFILES = ["M5_3layers", "M5_CB_GA3"]
H = 0.04


def _jax_mesh(monkeypatch, name, native):
    """The JAX package's mesh, its native switch read anew."""
    from vf_fem_tpu import native as jnative
    from vf_fem_tpu.mesh import m5_mesh as jm5

    monkeypatch.setenv("VF_FEM_TPU_NATIVE", "1" if native else "0")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    return jm5(name, h=H)


@pytest.fixture(scope="module", params=PROFILES)
def port_mesh(request):
    return request.param, m5_mesh(request.param, h=H)


def _facet_groups(mesh):
    """{facet marker: set of sorted vertex pairs}."""
    out = {}
    for f, m in zip(mesh.entities[1], mesh.mesh_functions[1]):
        if m:
            out.setdefault(int(m), set()).add(tuple(sorted(int(v) for v in f)))
    return out


def test_profile_names_match_jax():
    from vf_fem_tpu.mesh import m5_profile_names as jnames

    assert m5_profile_names() == jnames() and set(PROFILES) <= set(jnames())


def test_equals_jax_numpy_path(port_mesh, monkeypatch):
    name, tm = port_mesh
    jm = _jax_mesh(monkeypatch, name, native=False)
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    for d in (0, 1, 2):
        np.testing.assert_array_equal(tm.entities[d], jm.entities[d])
        np.testing.assert_array_equal(tm.mesh_functions[d], jm.mesh_functions[d])
        assert tm.subdomains[d] == jm.subdomains[d]
    assert {"body", "cover"} <= set(tm.subdomains[2])
    assert {"pressure", "fixed"} <= set(tm.subdomains[1])


def test_matches_jax_native_path(port_mesh, monkeypatch):
    name, tm = port_mesh
    jm = _jax_mesh(monkeypatch, name, native=True)
    np.testing.assert_allclose(tm.coords, jm.coords, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    np.testing.assert_array_equal(tm.mesh_functions[0], jm.mesh_functions[0])
    np.testing.assert_array_equal(tm.mesh_functions[2], jm.mesh_functions[2])
    assert _facet_groups(tm) == _facet_groups(jm)
    for d in (0, 1, 2):
        assert tm.subdomains[d] == jm.subdomains[d]


def test_gmsh_round_trip(port_mesh, tmp_path):
    _, tm = port_mesh
    path = write_gmsh(tm, str(tmp_path / "m5.msh"))
    back = load_gmsh(path)
    np.testing.assert_array_equal(back.coords, tm.coords)
    np.testing.assert_array_equal(back.cells, tm.cells)
    np.testing.assert_array_equal(back.mesh_functions[2], tm.mesh_functions[2])
    np.testing.assert_array_equal(back.mesh_functions[0], tm.mesh_functions[0])
    assert _facet_groups(back) == _facet_groups(tm)
    for d in (0, 1, 2):
        assert back.subdomains[d] == tm.subdomains[d]


def test_cached_mesh_builds_once(tmp_path):
    """The mesh cache writes the RCM-ordered mesh once; later calls read it
    back, and what they read is the built mesh."""
    from vf_fem_tpu_torch.mesh.cached import load_cached_m5_mesh, m5_cache_path
    from vf_fem_tpu_torch.mesh.reorder import rcm_mesh

    mesh, seconds = load_cached_m5_mesh("M5_CB_GA3", h=H, smooth_iters=5, cache_dir=tmp_path)
    assert seconds is not None and m5_cache_path("M5_CB_GA3", H, 5, tmp_path).exists()
    again, seconds = load_cached_m5_mesh("M5_CB_GA3", h=H, smooth_iters=5, cache_dir=tmp_path)
    assert seconds is None
    ref = rcm_mesh(m5_mesh("M5_CB_GA3", h=H, smooth_iters=5))
    for m in (mesh, again):
        np.testing.assert_array_equal(m.coords, ref.coords)
        np.testing.assert_array_equal(m.cells, ref.cells)
        assert _facet_groups(m) == _facet_groups(ref)
    assert [p.name for p in tmp_path.iterdir()] == ["M5_CB_GA3_h0.04_s5_rcm.msh"]
