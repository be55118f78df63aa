"""
The physics-only checks of the JAX package's tests, run on the port alone
(CPU, f64) at the JAX tests' gates:

- energy conservation of the undamped average-acceleration Newmark
  integrator, drift < 1e-8 (``tests/test_physics.py:60``);
- Newmark's second order in dt from a consistent start
  (``tests/test_physics.py:89``);
- the patch test: an affine displacement leaves the interior residual zero
  and the boundary rows the closed-form tractions
  (``tests/test_analytic.py:58``);
- Newmark temporal convergence from a released static preload, Richardson
  ratios near 4 (``tests/test_analytic.py:141``);
- the area-ratio separation point and flow of the Bernoulli fluid on a
  triangular constriction (``tests/test_fluid_semantics.py:57``);
- finite gradients at full glottal closure
  (``tests/test_fluid_semantics.py:112``).

Each check is the JAX test's at its own size, steps and gate.
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu_torch import forward, static
from vf_fem_tpu_torch.functional.solid import PeriodicEnergyError
from vf_fem_tpu_torch.load import load_fluid_model, load_solid_model
from vf_fem_tpu_torch.mesh import mark_unit_mesh_fixtures, unit_square_mesh
from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

EMOD = 1e4
# the solid here is linear (no contact, no load) and dt constant, so its
# Jacobian is the same at every iterate of every step: one factorization
# carried through the run (a refresh window longer than the run) gives the
# JAX tests' solution (the Jacobian rebuilt every iteration, their
# default) to the Newton tolerance, at a fifth of the time
ONCE = {"jacobian_refresh_steps": 1000}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops a step: one thread (see test_torch_ddstep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solid(mesh):
    return load_solid_model(mesh, slr.KelvinVoigt, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def undamped():
    """tests/test_physics.py:21-30: the 4 x 4 unit square, undamped, no
    contact."""
    model = _solid(mark_unit_mesh_fixtures(unit_square_mesh(4, 4)))
    model.prop.update(emod=np.full_like(model.prop["emod"], 1e4),
                      rho=np.full_like(model.prop["rho"], 1.0),
                      eta=np.full_like(model.prop["eta"], 0.0),
                      nu=np.full_like(model.prop["nu"], 0.3),
                      ycontact=np.full_like(model.prop["ycontact"], 100.0))
    return model


def _velocity_start(model, scale, seed):
    """Rest with a seeded initial velocity that holds the fixed boundary."""
    v0 = scale * np.random.default_rng(seed).standard_normal(model.ndof)
    v0[np.asarray(model.residual.bc_dofs)] = 0.0
    state0 = {k: np.zeros(model.ndof) for k in ("u", "v", "a")}
    state0["v"] = v0
    control = {k: np.zeros_like(v)[None] for k, v in model.control.items()}
    return state0, control


def test_energy_conservation(undamped):
    """Kinetic plus elastic energy every 10th of 79 steps within 1e-8 of
    the initial energy (relative)."""
    model = undamped
    state0, cs = _velocity_start(model, 0.1, 0)
    times = 1e-4 * np.arange(80)
    _, traj, _ = forward.integrate_pure(model, state0, cs, model.prop, times, ONCE)
    props = {k: torch.as_tensor(v) for k, v in model.prop.items()}
    energy = PeriodicEnergyError(model)._energy
    e0 = float(energy(torch.as_tensor(state0["u"]), torch.as_tensor(state0["v"]), props))
    es = np.array([float(energy(traj["u"][n], traj["v"][n], props))
                   for n in range(0, len(times) - 1, 10)])
    drift = np.abs(es - e0) / e0
    assert drift.max() < 1e-8, f"energy drift {drift.max():.2e}"


def test_newmark_second_order(undamped):
    """Free vibration from a velocity start (a consistent a0 = 0): the end
    state's error against 320 steps falls at rates in (1.7, 2.4) and
    (1.7, 2.6) from 10 to 20 to 40 steps."""
    model = undamped
    state0, cs = _velocity_start(model, 0.5, 1)
    fins = {n: forward.integrate_pure(model, state0, cs, model.prop,
                                      np.linspace(0.0, 2e-3, n + 1), ONCE)[0]["u"].numpy()
            for n in (10, 20, 40, 320)}
    errs = [np.linalg.norm(fins[n] - fins[320]) for n in (10, 20, 40)]
    rate1, rate2 = np.log2(errs[0] / errs[1]), np.log2(errs[1] / errs[2])
    assert 1.7 < rate1 < 2.4 and 1.7 < rate2 < 2.6, (rate1, rate2)


def _uniaxial(nx, ny):
    """tests/test_analytic.py:_uniaxial_model: the unit square clamped at
    y = 0, the pressure surface at y = 1, nu = 0, no contact."""
    mesh = unit_square_mesh(nx, ny)
    eps = 1e-12
    mesh.mark_entities(1, lambda m, v: np.all(v[..., 1] < eps, axis=-1), 1,
                       name="fixed", boundary_only=True)
    mesh.mark_entities(1, lambda m, v: np.all(v[..., 1] > 1 - eps, axis=-1), 2,
                       name="pressure", boundary_only=True)
    model = _solid(mesh)
    for k, v in dict(emod=EMOD, nu=0.0, rho=1.0, eta=0.0, ycontact=1e6,
                     kcontact=0.0).items():
        model.prop[k] = np.full_like(model.prop[k], v)
    return mesh, model


def test_patch_test_interior_residual_vanishes():
    """An affine u gives constant stress: the interior rows of the static
    residual vanish (1e-14 of its largest entry) and the free boundary rows
    equal the closed-form traction integrals (1e-12)."""
    mesh, model = _uniaxial(4, 3)
    A = np.array([[2e-3, 1e-3], [-5e-4, 3e-3]])
    b = np.array([1e-3, -2e-3])
    u = torch.as_tensor((mesh.coords @ A.T + b).reshape(-1))
    prop = {k: torch.as_tensor(v) for k, v in model.prop.items()}
    with torch.no_grad():
        res = model.res_u_static(u, {"p1": torch.zeros(mesh.num_vertices,
                                                        dtype=torch.float64)},
                                 prop).numpy().reshape(-1, 2)
    bverts = np.unique(mesh.facets[mesh.boundary_facets].reshape(-1))
    interior = np.setdiff1d(np.arange(mesh.num_vertices), bverts)
    scale = np.abs(res).max()
    assert interior.size > 0 and scale > 0
    np.testing.assert_allclose(res[interior], 0.0, atol=1e-14 * scale)

    eps3 = np.zeros((3, 3))
    eps3[:2, :2] = 0.5 * (A + A.T)
    sig = (2 * EMOD / 2 * eps3)[:2, :2]  # nu = 0: lambda = 0, mu = E / 2
    expected = np.zeros((mesh.num_vertices, 2))
    for f in mesh.boundary_facets:
        va, vb = mesh.facets[f]
        t = mesh.coords[vb] - mesh.coords[va]
        length = np.linalg.norm(t)
        n = np.array([t[1], -t[0]]) / length
        cen = mesh.coords[mesh.cells[mesh.facet_to_cell[f]]].mean(axis=0)
        if np.dot(cen - 0.5 * (mesh.coords[va] + mesh.coords[vb]), n) > 0:
            n = -n
        expected[va] += sig @ n * (length / 2)
        expected[vb] += sig @ n * (length / 2)
    free = np.ones(mesh.num_vertices, dtype=bool)
    free[np.unique(mesh.facets[mesh.facets_by_subdomain(["fixed"])].reshape(-1))] = False
    np.testing.assert_allclose(res[free], expected[free], atol=1e-12 * scale)


def test_newmark_temporal_convergence():
    """Free vibration from a static preload released at t = 0 (eta 0.5),
    its consistent initial acceleration from a micro-step: the Richardson
    ratios of the final u over 8, 16, 32, 64 steps lie in (3, 5.5)."""
    mesh, model = _uniaxial(4, 4)
    model.prop["eta"] = np.full_like(model.prop["eta"], 0.5)
    preload = {"p1": np.full(model.nvert, 0.05 * EMOD)}
    state0, _ = static.static_solid_configuration(model, preload, model.prop)
    cs = {"p1": np.zeros((1, model.nvert))}
    T = 2e-3
    fin0, _, _ = forward.integrate_pure(
        model, state0, cs, model.prop, np.array([0.0, 1e-4 * T]),
        {"absolute_tolerance": 1e-16, "relative_tolerance": 1e-15})
    state0["a"] = fin0["a"].numpy()
    finals = [forward.integrate_pure(
        model, state0, cs, model.prop, np.linspace(0.0, T, n + 1),
        {"absolute_tolerance": 1e-14, "relative_tolerance": 1e-14, **ONCE})[0]["u"].numpy()
        for n in (8, 16, 32, 64)]
    errs = [np.linalg.norm(finals[i] - finals[i + 1]) for i in range(3)]
    rates = [errs[i] / errs[i + 1] for i in range(2)]
    assert all(3.0 < r < 5.5 for r in rates), rates


def test_area_ratio_sep_separation_point():
    """A triangular constriction (area 1 -> 0.1 -> 1 over 21 points): the
    flow is Bernoulli's at the separation area r_sep a_min (rtol 1e-10)
    and the pressure is psup past the separation point (atol 1e-9)."""
    s = np.linspace(0.0, 1.0, 21)
    area = 1.0 - 0.9 * (1 - np.abs(2 * s - 1))
    model = load_fluid_model(s, flr.BernoulliAreaRatioSep, device="cpu", dtype=torch.float64)
    rho = 1.2e-3
    model.control.update(area=area, psub=np.array([8000.0]), psup=np.array([0.0]))
    model.prop.update(rho_air=np.array([rho]), r_sep=np.array([1.2]),
                      area_lb=np.array([1e-6]))
    qp, _ = model.solve_state1(model.state1)
    q, p = float(qp["q"][0]), np.asarray(qp["p"])
    i_min = int(np.argmin(area))
    a_sep = 1.2 * area[i_min]
    i_sep = i_min + int(np.argmin(np.abs(area[i_min:] - a_sep)))
    np.testing.assert_allclose(q, np.sqrt(2 / rho * 8000.0 / a_sep ** -2), rtol=1e-10)
    np.testing.assert_allclose(p[i_sep:], 0.0, atol=1e-9)


@pytest.mark.parametrize("cls", [flr.BernoulliSmoothMinSep, flr.BernoulliFixedSep],
                         ids=["smooth-min-sep", "fixed-sep"])
def test_gradients_finite_at_full_closure(cls):
    """A channel closed over three of 12 points (area 0): the fluid
    residual's value and its gradient in the area are finite."""
    s = np.linspace(0.0, 1.0, 12)
    kwargs = {"idx_sep": 6} if cls is flr.BernoulliFixedSep else {}
    resid = cls(s, device="cpu", dtype=torch.float64, **kwargs)
    state, control, prop = resid.res_args
    prop = {k: torch.ones_like(torch.as_tensor(v)) for k, v in prop.items()}
    prop["rho_air"] = torch.full_like(prop["rho_air"], 1.1225e-3)
    for k in ("zeta_min", "zeta_sep"):
        if k in prop:
            prop[k] = torch.full_like(prop[k], 1e-3)
    area = torch.full((12,), 0.5, dtype=torch.float64)
    area[5:8] = 0.0
    area.requires_grad_()
    zero = {k: torch.zeros_like(torch.as_tensor(v)) for k, v in state.items()}
    r = resid.res(zero, {"area": area, "psub": torch.tensor([8000.0], dtype=torch.float64),
                         "psup": torch.tensor([0.0], dtype=torch.float64)}, prop)
    val = torch.sum(r["q"] ** 2) + 1e-8 * torch.sum(r["p"] ** 2)
    (g,) = torch.autograd.grad(val, area)
    assert bool(torch.isfinite(val)) and bool(torch.isfinite(g).all())
