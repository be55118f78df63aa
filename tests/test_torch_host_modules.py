"""
The port's host-side modules against the JAX package's on the CPU:

- ``misc.signal``, ``mesh.dofmaps`` and ``constants`` on seeded inputs
  (exactly equal), and ``fem.continuum``'s contact-penalty helpers (rtol
  1e-15);
- ``vis.vis`` (matplotlib's Agg backend) and ``vis.xdmfutils``: the XDMF
  text written for the same stored run equals the JAX package's, and its
  exported datasets equal theirs (``tests/test_vis.py``'s checks);
- ``utils.line_search`` and ``functional_on_line_search``
  (``tests/test_forward.py:176-230``), and the same runs against the JAX
  package's line search (rtol 1e-10 plus 1e-12 of the field's largest
  entry; 1e-8 for v and a, which carry u's rounding times 2/dt and
  4/dt^2).
"""

import os
import shutil

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward, statefile as jsf
from vf_fem_tpu_torch import forward, statefile as sf

from fixture_models import make_vf_fsi_model
from port_fixtures import port_vf_model


def test_signal_matches_jax():
    from vf_fem_tpu.misc import signal as jsig
    from vf_fem_tpu_torch.misc import signal

    rng = np.random.default_rng(0)
    t = 5e-5 * np.arange(800)
    for f0 in (93.0, 141.0, 250.0):
        y = (np.sin(2 * np.pi * f0 * t) * np.exp(rng.uniform(-30, 30) * t)
             + 0.1 * rng.standard_normal(t.size))
        assert signal.fundamental_mode_from_rfft(y, 5e-5) == jsig.fundamental_mode_from_rfft(y, 5e-5)
        assert signal.is_oscillating(y) == jsig.is_oscillating(y)
    f0, _ = signal.fundamental_mode_from_rfft(np.sin(2 * np.pi * 125.0 * t), 5e-5)
    assert abs(f0 - 125.0) <= 1 / (t.size * 5e-5)


def test_constants_match_jax():
    import vf_fem_tpu.constants as jc
    import vf_fem_tpu_torch.constants as c

    names = [n for n in dir(jc) if n.isupper()]
    assert names and names == [n for n in dir(c) if n.isupper()]
    for n in names:
        assert getattr(c, n) == getattr(jc, n)


def test_dofmaps_match_jax():
    from vf_fem_tpu.load import load_solid_model as jload
    from vf_fem_tpu.mesh import dofmaps as jdm, load_gmsh as jgmsh
    from vf_fem_tpu.residuals import solid as jslr
    from vf_fem_tpu_torch.load import load_solid_model
    from vf_fem_tpu_torch.mesh import dofmaps as dm, load_gmsh
    from vf_fem_tpu_torch.residuals import solid as slr

    path = os.path.join(os.path.dirname(__file__), "..", "meshes", "M5_CB_GA3.msh")
    jmesh, mesh = jgmsh(path), load_gmsh(path)
    for dim in (1, 2):
        for name in mesh.subdomains[dim]:
            np.testing.assert_array_equal(dm.vertices_from_subdomain(mesh, dim, name),
                                          jdm.vertices_from_subdomain(jmesh, dim, name))
    for etype in ("facet", "cell"):
        for vector in (False, True):
            out = dm.process_meshlabel_to_dofs(mesh, etype, vector=vector)
            ref = jdm.process_meshlabel_to_dofs(jmesh, etype, vector=vector)
            assert list(out) == list(ref) and out
            for k in ref:
                np.testing.assert_array_equal(out[k], ref[k])
    for value in np.unique(mesh.mesh_functions[1]):
        np.testing.assert_array_equal(dm.dofs_from_mesh_func(mesh, 1, value, vector=True),
                                      jdm.dofs_from_mesh_func(jmesh, 1, value, vector=True))
    out = dm.process_celllabel_to_dofs_from_residual(
        load_solid_model(path, slr.KelvinVoigt, device="cpu").residual)
    ref = jdm.process_celllabel_to_dofs_from_residual(jload(path, jslr.KelvinVoigt).residual)
    assert list(out) == list(ref) == ["body", "cover"]
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """tests/test_vis.py's run (6 x 3, 6 steps), written by the JAX package
    into two copies of one file name; the port reads and exports one, the
    JAX package the other."""
    jm = make_vf_fsi_model(nx=6, ny=3)
    base = tmp_path_factory.mktemp("vis")
    for d in ("jax", "port"):
        os.makedirs(base / d)
    ini = jm.state0.copy()
    ini[:] = 0.0
    with jsf.StateFile(jm, str(base / "jax" / "run.h5"), mode="w") as f:
        jforward.integrate(jm, f, ini, [jm.control], jm.prop, 2e-5 * np.arange(6))
    shutil.copy(base / "jax" / "run.h5", base / "port" / "run.h5")
    tm = port_vf_model(nx=6, ny=3)
    jf = jsf.StateFile(jm, str(base / "jax" / "run.h5"), mode="a")
    tf = sf.StateFile(tm, str(base / "port" / "run.h5"), mode="a")
    yield jm, tm, jf, tf
    jf.close()
    tf.close()


def test_triangulation_and_figure(stored):
    import matplotlib.pyplot as plt
    from vf_fem_tpu.vis import vis as jvis
    from vf_fem_tpu_torch.vis import vis

    jm, tm, jf, tf = stored
    state = tf.get_state(tf.size - 1)
    fig, ax = vis.init_figure(tm, state)
    vis.update_figure(ax, tm, state)
    ax_gw = vis.plot_gw(tf, tm, ax=None)
    jax_gw = jvis.plot_gw(jf, jm, ax=None)
    np.testing.assert_allclose(ax_gw.lines[0].get_ydata(), jax_gw.lines[0].get_ydata(),
                               rtol=1e-12)
    vis.plot_grad(tm, np.asarray(state["u"]))
    tri, jtri = vis.triangulation(tm.solid.residual.mesh(), state["u"]), \
        jvis.triangulation(jm.solid.residual.mesh(), state["u"])
    np.testing.assert_array_equal(tri.x, jtri.x)
    np.testing.assert_array_equal(tri.triangles, jtri.triangles)
    plt.close("all")


def test_write_xdmf_matches_jax(stored):
    from vf_fem_tpu.vis import xdmfutils as jx
    from vf_fem_tpu_torch.vis import xdmfutils as x

    jm, tm, jf, tf = stored
    mesh = tm.solid.residual.mesh()
    cellvals = np.tile(np.arange(mesh.num_cells, dtype=float), (tf.size, 1))
    paths = []
    for mod, f in ((jx, jf), (x, tf)):
        mod.export_mesh_values(f, cellvals, "emod_cell", center="cell")
        paths.append(mod.write_xdmf(f, cell_fields=("emod_cell",)))
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1]
    assert texts[1].count("Grid Name=\"t") == tf.size
    for key in ("export/u", "export/v", "export/a", "export/coordinates_xyz",
                "export/emod_cell"):
        np.testing.assert_array_equal(tf.root_group[key][()], jf.root_group[key][()])
    e0 = np.asarray(tf.root_group["export/u"][0])
    assert np.all(e0[:, 2] == 0)


def test_export_mesh_values(stored):
    from vf_fem_tpu_torch.vis import xdmfutils as x

    _, tm, _, tf = stored
    vals = np.arange(tm.solid.nvert, dtype=float)
    assert x.export_mesh_values(tf, vals, "myfield") == "export/myfield"
    np.testing.assert_array_equal(tf.root_group["export/myfield"][()][0], vals)
    with pytest.raises(ValueError):
        x.export_mesh_values(tf, vals[:-1], "badfield", center="vertex")
    x.export_mesh_values(tf, np.zeros((2, tm.solid.nvert, 2)), "vecfield")
    assert tf.root_group["export/vecfield"].shape == (2, tm.solid.nvert, 3)


@pytest.fixture(scope="module")
def ls_models():
    jm = make_vf_fsi_model()
    return jm, port_vf_model()


def test_line_search(ls_models, tmp_path):
    """tests/test_forward.py's line search on the port: the h = 1 run is a
    direct run at psub + 1000, the functional is evaluated on every run
    and grows with psub; each run equals the JAX package's."""
    from vf_fem_tpu.utils import line_search as jline_search
    from vf_fem_tpu_torch.functional.solid import FinalDisplacementNorm
    from vf_fem_tpu_torch.utils import functional_on_line_search, line_search

    jm, tm = ls_models
    times = 2e-5 * np.arange(5)
    ini = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    dcontrol = {k: np.zeros_like(v) for k, v in tm.control.items()}
    dcontrol["psub"][:] = 1000.0
    dprop = {k: np.zeros_like(v) for k, v in tm.prop.items()}
    path = str(tmp_path / "ls.h5")
    line_search([0.0, 1.0], tm, ini, [tm.control], tm.prop, times, ini, [dcontrol],
                dprop, np.zeros_like(times), filepath=path)

    c1 = {k: v.copy() for k, v in tm.control.items()}
    c1["psub"][:] += 1000.0
    fin_direct, _ = forward.integrate(tm, None, ini, [c1], tm.prop, times, write=False)
    with sf.StateFile(tm, path, group="1", mode="r") as f:
        assert f.size == len(times)
        stored = f.get_state(f.size - 1)
    for k in ("u", "q", "p"):
        np.testing.assert_allclose(stored[k], fin_direct[k], rtol=1e-10, atol=1e-14)

    vals = functional_on_line_search([0.0, 1.0], FinalDisplacementNorm(tm), tm, path)
    assert vals.shape == (2,) and np.all(np.isfinite(vals))
    assert vals[1] > vals[0]

    jini = jm.state0.copy()
    jini[:] = 0.0
    jdc = jm.control.copy()
    jdc[:] = 0.0
    jdc["psub"][:] = 1000.0
    jdp = jm.prop.copy()
    jdp[:] = 0.0
    jpath = str(tmp_path / "ls_jax.h5")
    jline_search([0.0, 1.0], jm, jini, [jm.control], jm.prop, times, jini, [jdc], jdp,
                 np.zeros_like(times), filepath=jpath)
    for n in ("0", "1"):
        with sf.StateFile(tm, path, group=n, mode="r") as f, \
                sf.StateFile(tm, jpath, group=n, mode="r") as g:
            for key in ("state", "control"):
                for k, v in g.root_group[key].items():
                    ref = v[()]
                    # v and a carry Newton's last-iterate rounding in u
                    # times 2/dt and 4/dt^2
                    rel = 1e-8 if k in ("v", "a") else 1e-12
                    np.testing.assert_allclose(f.root_group[key][k][()], ref, rtol=1e-10,
                                               atol=rel * np.abs(ref).max(), err_msg=k)
            np.testing.assert_array_equal(f.get_times(), g.get_times())


def test_line_search_p(ls_models, tmp_path):
    """The property line search: run h is a direct run at ``p + h dp``."""
    from vf_fem_tpu_torch.utils import line_search_p

    _, tm = ls_models
    times = 2e-5 * np.arange(4)
    dp = {k: np.zeros_like(v) for k, v in tm.prop.items()}
    dp["emod"][:] = -1e4
    path = line_search_p([0.5], tm, tm.prop, dp, times=times,
                         filepath=str(tmp_path / "lsp.h5"))
    p1 = {k: v + 0.5 * dp[k] for k, v in tm.prop.items()}
    ini = {k: np.zeros_like(v) for k, v in tm.state0.items()}
    fin, _ = forward.integrate(tm, None, ini, [tm.control], p1, times, write=False)
    with sf.StateFile(tm, path, group="0", mode="r") as f:
        np.testing.assert_array_equal(f.get_prop()["emod"], p1["emod"])
        np.testing.assert_allclose(f.get_state(f.size - 1)["u"], fin["u"], rtol=1e-12,
                                   atol=1e-18)


def test_cubic_penalty_helpers_match_jax():
    """``fem.continuum``'s contact-penalty helpers on seeded gaps of both
    signs, against the JAX package's (f64; the same expressions)."""
    from vf_fem_tpu.fem import continuum as jc
    from vf_fem_tpu_torch.fem import continuum as c

    gap = np.random.default_rng(9).standard_normal(64) * 1e-2
    gap[:3] = 0.0
    t = torch.as_tensor(gap)
    np.testing.assert_array_equal(c.positive_gap(t).numpy(), np.asarray(jc.positive_gap(gap)))
    np.testing.assert_allclose(c.pressure_contact_cubic_penalty(t, 1e8).numpy(),
                               np.asarray(jc.pressure_contact_cubic_penalty(gap, 1e8)),
                               rtol=1e-15, atol=0)
    for out, ref in zip(c.dform_cubic_penalty_pressure(t, 1e8),
                        jc.dform_cubic_penalty_pressure(gap, 1e8)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-15, atol=0)
