"""
The port's extruded-3D geometry and meshes against the JAX package's, live
on the CPU in f64:

- P1 tetrahedra: ``det3``, ``inv3``, ``cell_shape_gradients`` and the
  triangle ``facet_measure_normal`` on seeded tetrahedra (rtol 1e-13), and
  the quadratures of both dimensions;
- ``unit_cube_mesh`` with ``mark_unit_mesh_fixtures``, ``extrude_mesh``
  (``vocal_fold_mesh(6, 3)`` through 3 planes over 0.4 cm, and M5_CB_GA3 at
  h 0.1 through 3 planes over 1.5 cm), ``rcm_mesh`` and
  ``derive_1d_interface(..., zs)``: identical arrays and markers (the JAX
  package's native facet kernels switched off, ``VF_FEM_TPU_NATIVE=0``;
  with them the facet table is ordered differently);
- ``tests/test_fem.py::test_inertial_mass_consistency[nz=2]`` on the port;
- one ``assemble_res`` (banded and plain) and one dense Newton Jacobian of
  KelvinVoigt on the extruded mesh at a seeded state, within 1e-12 of the
  largest entry, and the block-Jacobi inverse of 3 x 3 nodal blocks.
"""

import jax
import numpy as np
import pytest
import torch

from vf_fem_tpu.fem import elements as jel
from vf_fem_tpu_torch.convert import to_tensors
from vf_fem_tpu_torch.fem import elements as tel

F64 = torch.float64
VF_ZS = np.linspace(0.0, 0.4, 3)
M5_ZS = np.linspace(0.0, 1.5, 3)


def _tets(n=64, seed=0):
    """Seeded tetrahedra, positively and negatively oriented alike."""
    rng = np.random.default_rng(seed)
    base = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    return base[None] + 0.3 * rng.standard_normal((n, 4, 3))


def test_det3_inv3():
    A = np.random.default_rng(1).standard_normal((64, 3, 3))
    t = torch.as_tensor(A)
    np.testing.assert_allclose(tel.det3(t).numpy(), np.asarray(jel.det3(A)), rtol=1e-13)
    np.testing.assert_allclose(tel.inv3(t).numpy(), np.asarray(jel.inv3(A)), rtol=1e-13,
                               atol=1e-13 * np.abs(np.linalg.inv(A)).max())
    np.testing.assert_allclose(tel.inv_small(t).numpy() @ A, np.broadcast_to(np.eye(3), A.shape),
                               atol=1e-12)


def test_cell_shape_gradients_tet():
    X = _tets()
    grads, vol = tel.cell_shape_gradients(torch.as_tensor(X))
    jg, jv = jax.vmap(jel.cell_shape_gradients)(X)
    np.testing.assert_allclose(vol.numpy(), np.asarray(jv), rtol=1e-13)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jg), rtol=1e-13,
                               atol=1e-13 * np.abs(np.asarray(jg)).max())
    # partition of unity: the gradients sum to zero
    assert np.abs(grads.sum(-2).numpy()).max() < 1e-12 * np.abs(grads.numpy()).max()


def test_facet_measure_normal_triangle():
    X = _tets(seed=2)
    Xf, Xo = X[:, 1:], X[:, 0]
    meas, n = tel.facet_measure_normal(torch.as_tensor(Xf), torch.as_tensor(Xo))
    jm, jn = jax.vmap(jel.facet_measure_normal)(Xf, Xo)
    np.testing.assert_allclose(meas.numpy(), np.asarray(jm), rtol=1e-13)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=1e-13, atol=1e-13)
    # outward: away from the opposite vertex
    assert (((Xo - Xf[:, 0]) * n.numpy()).sum(-1) < 0).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_quadratures(dim):
    for a, b in zip(tel.cell_quadrature(dim) + tel.facet_quadrature(dim),
                    jel.cell_quadrature(dim) + jel.facet_quadrature(dim)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="dimension"):
        tel.cell_quadrature(4)


@pytest.fixture
def jax_mesh(monkeypatch):
    """The JAX package's mesh module with its native kernels switched off."""
    from vf_fem_tpu import mesh as jmesh
    from vf_fem_tpu import native as jnative

    monkeypatch.setenv("VF_FEM_TPU_NATIVE", "0")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    return jmesh


def _same_mesh(tm, jm):
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    assert sorted(tm.entities) == sorted(jm.entities)
    for d in jm.entities:
        np.testing.assert_array_equal(tm.entities[d], jm.entities[d], err_msg=f"dim {d}")
        np.testing.assert_array_equal(tm.mesh_functions[d], jm.mesh_functions[d],
                                      err_msg=f"dim {d}")
        assert tm.subdomains[d] == jm.subdomains[d], d
    np.testing.assert_array_equal(tm.boundary_facets, jm.boundary_facets)
    np.testing.assert_array_equal(tm.facet_to_cell, jm.facet_to_cell)
    np.testing.assert_array_equal(tm.facet_opposite_local_vertex,
                                  jm.facet_opposite_local_vertex)


def _meshes(name, jmesh):
    """(port mesh, JAX mesh, planes) of a 3D fixture."""
    from vf_fem_tpu.mesh.extrude import extrude_mesh as jextrude
    from vf_fem_tpu_torch import mesh as tmesh
    from vf_fem_tpu_torch.mesh.extrude import extrude_mesh as textrude

    if name == "cube":
        zs = np.linspace(0.0, 1.0, 3)
        return (tmesh.mark_unit_mesh_fixtures(tmesh.unit_cube_mesh(3, 3, 2)),
                jmesh.mark_unit_mesh_fixtures(jmesh.unit_cube_mesh(3, 3, 2)), zs)
    if name == "vf63":
        return (textrude(tmesh.vocal_fold_mesh(6, 3), VF_ZS),
                jextrude(jmesh.vocal_fold_mesh(6, 3), VF_ZS), VF_ZS)
    return (textrude(tmesh.m5_mesh("M5_CB_GA3", h=0.1, smooth_iters=5), M5_ZS),
            jextrude(jmesh.m5_mesh("M5_CB_GA3", h=0.1, smooth_iters=5), M5_ZS), M5_ZS)


@pytest.mark.parametrize("name", ["cube", "vf63", "m5"])
def test_meshes_identical(name, jax_mesh):
    """Marked unit cube and the extrusions: arrays, markers and names;
    then the same after RCM renumbering, and the 1D interface on each
    z-plane."""
    from vf_fem_tpu.mesh.reorder import rcm_mesh as jrcm
    from vf_fem_tpu_torch.mesh import derive_1d_interface
    from vf_fem_tpu_torch.mesh.reorder import rcm_mesh as trcm

    tm, jm, zs = _meshes(name, jax_mesh)
    assert tm.dim == 3
    _same_mesh(tm, jm)
    if name == "cube":
        assert tm.subdomains[2] == {"fixed": 1, "pressure": 0}
        assert (tm.mesh_functions[1] == 1).sum() == 2  # the separation edges (x = y = 1)
    else:
        assert {"pressure", "fixed"} <= set(tm.subdomains[2])
        assert tm.num_cells == 3 * 2 * (jm.num_cells // 6)
    tr, jr = trcm(tm), jrcm(jm)
    _same_mesh(tr, jr)
    for t, j in ((tm, jm), (tr, jr)):
        for a, b in zip(derive_1d_interface(t, ("pressure",), zs),
                        jax_mesh.derive_1d_interface(j, ("pressure",), zs)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="zs"):
        derive_1d_interface(tr, ("pressure",))


def test_extrude_volume_and_caps():
    """The extrusion's volume is the profile's area times its length, and
    the end caps are fixed (test_fsi_3d.py::test_extruded_m5_3d_fsi)."""
    from vf_fem_tpu_torch.mesh import m5_mesh
    from vf_fem_tpu_torch.mesh.extrude import extrude_mesh

    m2 = m5_mesh("M5_CB_GA3", h=0.1, smooth_iters=5)
    m3 = extrude_mesh(m2, M5_ZS)
    p = m3.coords[m3.cells]
    v = np.abs(np.linalg.det(p[:, 1:] - p[:, :1])).sum() / 6.0
    p2 = m2.coords[m2.cells]
    e1, e2 = p2[:, 1] - p2[:, 0], p2[:, 2] - p2[:, 0]
    area = np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum() / 2.0
    np.testing.assert_allclose(v, area * 1.5, rtol=1e-10)
    assert set(m3.subdomains[3]) == {"body", "cover"}
    fixed = m3.facets[m3.mesh_functions[2] == m3.subdomains[2]["fixed"]]
    z = m3.coords[fixed][..., 2]
    caps = (np.all(z == 0.0, axis=1) | np.all(z == 1.5, axis=1)).sum()
    assert caps == 2 * m2.num_cells
    with pytest.raises(ValueError, match="z-planes"):
        extrude_mesh(m2, [0.0])


@pytest.mark.parametrize("native", ["0", "1"])
def test_mesh_digest(native, monkeypatch, tmp_path):
    """``chip_smoke.mesh_digest``, to which phase 17 holds the port's 45.8k
    mesh on the card: the same for the port's RCM-ordered extruded M5, the
    JAX package's (with its native facet kernels on, which order the facet
    table differently, and off) and the port's read back from its
    ``.msh`` file; another for one marker moved."""
    import chip_smoke as cs
    from vf_fem_tpu import native as jnative
    from vf_fem_tpu import mesh as jmesh
    from vf_fem_tpu.mesh.extrude import extrude_mesh as jextrude
    from vf_fem_tpu.mesh.reorder import rcm_mesh as jrcm
    from vf_fem_tpu_torch.mesh import load_gmsh, m5_mesh
    from vf_fem_tpu_torch.mesh.extrude import extrude_mesh
    from vf_fem_tpu_torch.mesh.reorder import rcm_mesh
    from vf_fem_tpu_torch.mesh.writers import write_gmsh

    monkeypatch.setenv("VF_FEM_TPU_NATIVE", native)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    tm = rcm_mesh(extrude_mesh(m5_mesh("M5_CB_GA3", h=0.1, smooth_iters=5), M5_ZS))
    jm = jrcm(jextrude(jmesh.m5_mesh("M5_CB_GA3", h=0.1, smooth_iters=5), M5_ZS))
    back = load_gmsh(write_gmsh(tm, str(tmp_path / "m5x.msh")))
    digest = cs.mesh_digest(tm)
    assert cs.mesh_digest(jm) == cs.mesh_digest(back) == digest
    np.testing.assert_array_equal(back.coords, jm.coords)
    marked = np.flatnonzero(tm.mesh_functions[2])
    tm.mesh_functions[2][marked[0]] = 0
    assert cs.mesh_digest(tm) != digest


def test_inertial_mass_consistency_3d():
    """tests/test_fem.py::test_inertial_mass_consistency[nz=2] on the port:
    with rho = 1, a constant acceleration and every other field zero, the
    residual sums to the volume times the acceleration."""
    from vf_fem_tpu_torch.mesh import mark_unit_mesh_fixtures, unit_cube_mesh
    from vf_fem_tpu_torch.residuals import solid as slr

    mesh = mark_unit_mesh_fixtures(unit_cube_mesh(3, 3, 2))
    R = slr.KelvinVoigt(mesh, device="cpu", dtype=F64)
    fields = {k: torch.zeros(R.coefficient_shape(k), dtype=F64) for k in R.coefficient_spec}
    fields["prop/rho"] = torch.ones(mesh.num_cells, dtype=F64)
    fields["prop/ycontact"] = torch.tensor([np.inf], dtype=F64)
    fields["prop/ncontact"] = torch.tensor([0.0, 1.0, 0.0], dtype=F64)
    fields["prop/kcontact"] = torch.tensor([1.0], dtype=F64)
    a = torch.zeros((mesh.num_vertices, 3), dtype=F64)
    a[:, 0] = 2.0
    fields["state/a1"] = a
    for banded in (True, False):
        total = R.assemble_res(fields, banded=banded).numpy().sum(axis=0)
        np.testing.assert_allclose(total[0], 2.0, rtol=1e-12)
        np.testing.assert_allclose(total[1:], 0.0, atol=1e-12)


def _random_fields(spec_shapes, rng):
    """Plausible seeded values of KelvinVoigt's coefficients (the contact
    plane through the fold's upper part: the penalty engaged)."""
    table = {
        "rho": lambda s: rng.uniform(0.5, 1.5, s),
        "emod": lambda s: rng.uniform(1e4, 1e5, s),
        "eta": lambda s: rng.uniform(1.0, 5.0, s),
        "nu": lambda s: np.full(s, 0.45),
        "ycontact": lambda s: np.full(s, 0.4),
        "ncontact": lambda s: np.array([0.0, 1.0, 0.0]),
        "kcontact": lambda s: np.full(s, 1e8),
        "p1": lambda s: 1e3 * rng.random(s),
        "tcontact": lambda s: 1e2 * rng.standard_normal(s),
    }
    out = {}
    for key, shape in spec_shapes.items():
        name = key.split("/", 1)[1]
        out[key] = (1e-3 * rng.standard_normal(shape) if key.startswith("state/")
                    else table[name](shape))
    return out


def test_kelvin_voigt_residual_and_jacobian_3d(jax_mesh):
    """One residual (banded and plain) and one dense Newton Jacobian of
    KelvinVoigt on the extruded vocal fold, against the JAX package's, and
    the block-Jacobi inverse of 3 x 3 nodal blocks against numpy's."""
    from vf_fem_tpu.load import load_solid_model as jload
    from vf_fem_tpu.residuals import solid as jslr
    from vf_fem_tpu_torch.fem.assembly import EBEOperator, ebe_plans
    from vf_fem_tpu_torch.load import load_solid_model as tload
    from vf_fem_tpu_torch.residuals import solid as tslr

    tmesh, jmesh, _ = _meshes("vf63", jax_mesh)
    jR = jslr.KelvinVoigt(jmesh)
    tR = tslr.KelvinVoigt(tmesh, device="cpu", dtype=F64)
    assert list(tR.coefficient_spec) == list(jR.coefficient_spec) and tR.banded_ok()
    rng = np.random.default_rng(11)
    fields = _random_fields({k: jR.coefficient_shape(k) for k in jR.coefficient_spec}, rng)
    ref = np.asarray(jax.jit(jR.assemble_res)(fields))
    for banded in (True, False):
        out = tR.assemble_res(to_tensors(fields, "cpu", F64), banded=banded).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())

    jm = jload(jmesh, jslr.KelvinVoigt)
    tm = tload(tmesh, tslr.KelvinVoigt, device="cpu", dtype=F64)
    prop = {k: v.reshape(-1) for k, v in
            _random_fields({"prop/" + k: np.shape(v) for k, v in
                            jm.prop_to_dict(jm.prop).items()}, rng).items()}
    prop = {k.split("/", 1)[1]: v for k, v in prop.items()}
    state0 = {k: 1e-3 * rng.standard_normal(tm.ndof) for k in ("u", "v", "a")}
    control = {"p1": 1e3 * rng.random(tm.nvert)}
    u1 = 1e-2 * rng.standard_normal(tm.ndof)
    dt = 1e-4
    Jref = np.asarray(jax.jit(jm.jac_u_dense, static_argnums=4)(u1, state0, control, prop, dt))
    t = lambda d: to_tensors(d, "cpu", F64)
    J = tm.jac_u_dense(torch.from_numpy(u1), t(state0), t(control), t(prop), dt).numpy()
    np.testing.assert_allclose(J, Jref, rtol=0, atol=1e-12 * np.abs(Jref).max())

    # block-Jacobi: the 3 x 3 nodal diagonal blocks of a random symmetric
    # positive element operator, inverted in closed form
    cells = np.asarray(tmesh.cells)
    nld = 12
    B = rng.standard_normal((len(cells), nld, nld))
    Je = torch.as_tensor(B @ B.transpose(0, 2, 1) + nld * np.eye(nld))
    dofs = torch.as_tensor((cells[:, :, None] * 3 + np.arange(3)).reshape(len(cells), nld))
    bc = torch.as_tensor(np.arange(6))
    op = EBEOperator(Je, dofs, None, None, bc, ebe_plans([cells], tmesh.num_vertices, 3, "cpu"))
    Dinv = op.block_diag_inverse(3).numpy()
    A = np.zeros((tm.ndof, tm.ndof))
    for e in range(len(cells)):
        A[np.ix_(dofs[e].numpy(), dofs[e].numpy())] += Je[e].numpy()
    A[:6] = 0.0
    A[:, :6] = 0.0
    A[np.arange(6), np.arange(6)] = 1.0
    blocks = np.stack([A[3 * n:3 * n + 3, 3 * n:3 * n + 3] for n in range(tmesh.num_vertices)])
    np.testing.assert_allclose(Dinv, np.linalg.inv(blocks), rtol=1e-12,
                               atol=1e-14 * np.abs(Dinv).max())
