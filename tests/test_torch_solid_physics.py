"""
The seven solid residuals the port added to ``KelvinVoigt``,
``KelvinVoigtWShape`` and ``KelvinVoigtWEpithelium`` (``Rayleigh``, the
four swelling solids and ``Approximate3DKelvinVoigt``), against the JAX
package in f64 on ``vocal_fold_mesh(12, 6)`` with random fields from a
numpy seed: ``assemble_res`` through the banded and the plain cell pass
(rtol 1e-12) and the dense Newton Jacobian (rtol 1e-11), the tolerances
of ``tests/test_torch_residual.py``.  Then the form-family identities of
``tests/test_fem.py`` on the port alone: every residual assembles,
rigid translation gives a zero residual, swelling at unit volume reduces
to linear elasticity to second order, Rayleigh mass damping integrates
the mass exactly, and the declared ``nu`` of the swelling laws is live
(``torch.autograd`` against a central difference).
"""

import jax
import numpy as np
import pytest
import torch

from vf_fem_tpu.load import load_solid_model as jload_solid
from vf_fem_tpu.mesh import vocal_fold_mesh as jvf_mesh
from vf_fem_tpu.residuals import solid as jslr
from vf_fem_tpu_torch.convert import to_tensors
from vf_fem_tpu_torch.load import load_solid_model as tload_solid
from vf_fem_tpu_torch.mesh import mark_unit_mesh_fixtures, unit_square_mesh
from vf_fem_tpu_torch.mesh import vocal_fold_mesh as tvf_mesh
from vf_fem_tpu_torch.residuals import solid as tslr

F64 = torch.float64
NEW_SOLIDS = [
    "Rayleigh",
    "IncompSwellingKelvinVoigt",
    "SwellingKelvinVoigt",
    "SwellingKelvinVoigtWEpithelium",
    "SwellingKelvinVoigtWEpitheliumNoShape",
    "SwellingPowerLawKelvinVoigtWEpitheliumNoShape",
    "Approximate3DKelvinVoigt",
]


def _random_value(key, shape, rng):
    """Physically plausible random coefficient values (swelling volumes
    about 1, so that the prestress at u = 0 is live)."""
    name = key.split("/", 1)[1]
    if key.startswith("state/"):
        return 1e-2 * rng.standard_normal(shape)
    table = {
        "p1": lambda: 1e3 * rng.random(shape),
        "tcontact": lambda: 1e2 * rng.standard_normal(shape),
        "rho": lambda: rng.uniform(0.5, 1.5, shape),
        "emod": lambda: rng.uniform(1e4, 1e5, shape),
        "eta": lambda: rng.uniform(1.0, 5.0, shape),
        "nu": lambda: np.full(shape, 0.42),
        "emod_membrane": lambda: rng.uniform(1e4, 1e5, shape)
        * (rng.random(shape) > 0.33),
        "nu_membrane": lambda: rng.uniform(0.2, 0.45, shape),
        "th_membrane": lambda: rng.uniform(0.0, 0.05, shape),
        "ycontact": lambda: np.full(shape, 0.6),
        "ncontact": lambda: np.array([0.0, 1.0]),
        "kcontact": lambda: np.full(shape, 1e8),
        "v_swelling": lambda: rng.uniform(0.9, 1.1, shape),
        "k_swelling": lambda: rng.uniform(1e3, 1e5, shape),
        "m_swelling": lambda: rng.uniform(-1.0, 1.0, shape),
        "rayleigh_m": lambda: np.full(shape, 1.7),
        "rayleigh_k": lambda: np.full(shape, 2e-4),
        "u_ant": lambda: 1e-2 * rng.standard_normal(shape),
        "u_pos": lambda: 1e-2 * rng.standard_normal(shape),
        "length": lambda: rng.uniform(0.5, 2.0, shape),
        "muscle_stress": lambda: rng.uniform(0.0, 1e3, shape),
    }
    return table[name]()


@pytest.fixture(scope="module", params=NEW_SOLIDS)
def residual_pair(request):
    jR = getattr(jslr, request.param)(jvf_mesh(12, 6))
    tR = getattr(tslr, request.param)(tvf_mesh(12, 6), device="cpu", dtype=F64)
    # the same coefficients, spaces and defaults in the same order
    spec = lambda R: [(k, s.space, s.default) for k, s in R.coefficient_spec.items()]
    assert spec(tR) == spec(jR)
    rng = np.random.default_rng(11)
    fields = {k: _random_value(k, jR.coefficient_shape(k), rng)
              for k in jR.coefficient_spec}
    return jR, tR, fields


@pytest.mark.parametrize("banded", [True, False], ids=["banded", "plain"])
def test_assemble_res_matches_jax(residual_pair, banded):
    jR, tR, fields = residual_pair
    assert tR.banded_ok()
    ref = np.asarray(jax.jit(jR.assemble_res)(fields))
    out = tR.assemble_res(to_tensors(fields, "cpu", F64), banded=banded)
    np.testing.assert_allclose(
        out.numpy(), ref, rtol=1e-12, atol=1e-15 * np.abs(ref).max()
    )


@pytest.mark.parametrize("solid", NEW_SOLIDS)
def test_jac_u_dense_matches_jax(solid):
    jm = jload_solid(jvf_mesh(12, 6), getattr(jslr, solid))
    tm = tload_solid(tvf_mesh(12, 6), getattr(tslr, solid), device="cpu", dtype=F64)
    rng = np.random.default_rng(12)
    jprop = jm.prop_to_dict(jm.prop)
    assert list(tm.prop) == list(jprop)
    prop = {k: _random_value("prop/" + k, v.shape, rng).reshape(v.shape)
            for k, v in jprop.items()}
    prop["ycontact"] = np.array([0.45])  # contact engaged on part of the surface
    state0 = {k: 1e-3 * rng.standard_normal(tm.ndof) for k in ("u", "v", "a")}
    control = {"p1": 1e3 * rng.random(tm.nvert)}
    u1 = 1e-2 * rng.standard_normal(tm.ndof)
    dt = 1e-4
    ref = np.asarray(jax.jit(jm.jac_u_dense, static_argnums=4)(
        u1, state0, control, prop, dt))
    t = lambda d: to_tensors(d, "cpu", F64)
    out = tm.jac_u_dense(torch.from_numpy(u1), t(state0), t(control), t(prop), dt)
    np.testing.assert_allclose(
        out.numpy(), ref, rtol=1e-11, atol=1e-15 * np.abs(ref).max()
    )


# -- form-family identities (tests/test_fem.py) on the port alone --------------


def _unit_mesh(n):
    return mark_unit_mesh_fixtures(unit_square_mesh(n, n))


def _zero_fields(R):
    """Zero fields with contact and pressure inert and the swelling and
    anterior-posterior coefficients neutral (``tests/test_fem.py:159``)."""
    fields = {k: torch.zeros(R.coefficient_shape(k), dtype=F64)
              for k in R.coefficient_spec}
    for key, val in (("prop/ycontact", np.inf), ("prop/kcontact", 0.0),
                     ("prop/nu", 0.45), ("prop/v_swelling", 1.0),
                     ("prop/m_swelling", 0.0), ("prop/length", 1.0),
                     ("prop/muscle_stress", 0.0)):
        if key in fields:
            fields[key] = torch.full_like(fields[key], val)
    if "prop/ncontact" in fields:
        fields["prop/ncontact"] = torch.tensor([0.0, 1.0], dtype=F64)
    return fields


@pytest.mark.parametrize("solid", [
    "Rayleigh", "KelvinVoigt", "KelvinVoigtWEpithelium", "SwellingKelvinVoigt",
    "IncompSwellingKelvinVoigt", "SwellingPowerLawKelvinVoigtWEpitheliumNoShape",
    "Approximate3DKelvinVoigt", "KelvinVoigtWShape",
])
def test_residual_assembles(solid):
    mesh = _unit_mesh(3)
    R = getattr(tslr, solid)(mesh, device="cpu", dtype=F64)
    rng = np.random.default_rng(0)
    fields = {k: torch.as_tensor(_random_value(k, R.coefficient_shape(k), rng)
                                 if k != "prop/umesh" else np.zeros(R.coefficient_shape(k)))
              for k in R.coefficient_spec}
    for banded in (True, False):
        res = R.assemble_res(fields, banded=banded).numpy()
        assert res.shape == (mesh.num_vertices, 2)
        assert np.all(np.isfinite(res))
        assert np.linalg.norm(res) > 0


@pytest.mark.parametrize("solid", [
    "Rayleigh", "KelvinVoigt", "KelvinVoigtWEpithelium", "IncompSwellingKelvinVoigt",
    "SwellingKelvinVoigt", "SwellingKelvinVoigtWEpithelium",
    "SwellingPowerLawKelvinVoigtWEpitheliumNoShape",
    # not Approximate3DKelvinVoigt: its anterior-posterior force is the
    # restoring force of the clamped planes beside the section, which
    # reacts to a rigid in-plane translation by design
])
def test_translation_invariance_per_family(solid):
    """A rigid translation gives a zero residual for every form family."""
    mesh = _unit_mesh(4)
    R = getattr(tslr, solid)(mesh, device="cpu", dtype=F64)
    fields = _zero_fields(R)
    fields["prop/emod"] = torch.full((mesh.num_cells,), 3e4, dtype=F64)
    if "prop/rho" in fields:
        fields["prop/rho"] = torch.ones(mesh.num_cells, dtype=F64)
    fields["state/u1"] = torch.tensor([0.37, -0.12], dtype=F64).repeat(mesh.num_vertices, 1)
    for banded in (True, False):
        res = R.assemble_res(fields, banded=banded).numpy()
        np.testing.assert_allclose(res, 0.0, atol=1e-12 * 3e4 * mesh.num_vertices)


def test_swelling_reduces_to_elastic_at_unit_volume():
    """At v_swelling = 1 the swelling law is linear elasticity up to
    O(|grad u|^2): halving the strain halves the relative difference."""
    mesh = _unit_mesh(4)
    pair = [getattr(tslr, s)(mesh, device="cpu", dtype=F64)
            for s in ("SwellingKelvinVoigt", "KelvinVoigt")]
    errs = []
    for eps in (1e-3, 5e-4, 2.5e-4):
        A = eps * np.array([[1.0, 0.3], [0.2, -0.5]])
        out = []
        for R in pair:
            fields = _zero_fields(R)
            fields["prop/emod"] = torch.full((mesh.num_cells,), 3e4, dtype=F64)
            fields["state/u1"] = torch.as_tensor(mesh.coords @ A.T)
            out.append(R.assemble_res(fields, banded=True).numpy())
        errs.append(np.abs(out[0] - out[1]).max() / np.abs(out[1]).max())
    assert errs[0] / errs[1] > 1.7
    assert errs[1] / errs[2] > 1.7


def test_rayleigh_mass_damping_identity():
    """Mass-only Rayleigh damping of a constant velocity integrates to
    rayleigh_m * mass * v (the unit square's mass is 1)."""
    mesh = _unit_mesh(4)
    R = tslr.Rayleigh(mesh, device="cpu", dtype=F64)
    fields = _zero_fields(R)
    fields["prop/emod"] = torch.full((mesh.num_cells,), 3e4, dtype=F64)
    fields["prop/rho"] = torch.ones(mesh.num_cells, dtype=F64)
    fields["prop/rayleigh_m"] = torch.tensor([2.5], dtype=F64)
    fields["prop/rayleigh_k"] = torch.zeros(1, dtype=F64)
    fields["state/v1"] = torch.tensor([3.0, 0.0], dtype=F64).repeat(mesh.num_vertices, 1)
    total = R.assemble_res(fields, banded=True).numpy().sum(axis=0)
    np.testing.assert_allclose(total[0], 2.5 * 3.0, rtol=1e-12)
    np.testing.assert_allclose(total[1], 0.0, atol=1e-12)


@pytest.mark.parametrize(
    "solid", ["SwellingKelvinVoigt", "SwellingPowerLawKelvinVoigtWEpitheliumNoShape"]
)
def test_swelling_nu_is_live(solid):
    """d|res|^2 / d nu is nonzero and agrees with a central difference: the
    swelling laws read the declared nu (femvf hard-codes 0.45)."""
    mesh = _unit_mesh(3)
    R = getattr(tslr, solid)(mesh, device="cpu", dtype=F64)
    fields = _zero_fields(R)
    fields["prop/emod"] = torch.full((mesh.num_cells,), 3e4, dtype=F64)
    A = 1e-2 * np.array([[1.0, 0.3], [0.2, -0.5]])
    fields["state/u1"] = torch.as_tensor(mesh.coords @ A.T)

    def total_sq(nu):
        r = R.assemble_res({**fields, "prop/nu": nu.reshape(1)}, banded=True)
        return torch.sum(r * r)

    nu0 = torch.tensor(0.3, dtype=F64, requires_grad=True)
    value = total_sq(nu0)
    (g,) = torch.autograd.grad(value, nu0)
    assert abs(float(g)) > 1e-6 * abs(float(value.detach()))
    h = 1e-5
    with torch.no_grad():
        g_fd = (float(total_sq(nu0 + h)) - float(total_sq(nu0 - h))) / (2 * h)
    np.testing.assert_allclose(float(g), g_fd, rtol=1e-4)
