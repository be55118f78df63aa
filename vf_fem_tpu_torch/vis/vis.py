"""
Matplotlib visualization helpers (counterpart of ``vf_fem_tpu.vis.vis``;
reference: ``src/femvf/vis/vis.py``).  matplotlib is imported inside the
functions, so importing this module needs none.  Vectors are dicts of
numpy arrays or tensors (copied to the host).
"""

from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.asarray(a)


def triangulation(mesh, u=None):
    """Return a ``matplotlib.tri.Triangulation`` of the (optionally
    deformed) mesh (reference: ``vis/vis.py:12-40``)."""
    from matplotlib.tri import Triangulation

    coords = np.asarray(mesh.coords)
    if u is not None:
        coords = coords + _host(u).reshape(coords.shape)
    if mesh.dim != 2:
        raise ValueError("triangulation only supports 2D meshes")
    return Triangulation(coords[:, 0], coords[:, 1], np.asarray(mesh.cells))


def init_figure(model, state=None):
    """Create a figure showing the (deformed) mesh and glottal midline
    (reference: ``vis/vis.py:43-90``)."""
    import matplotlib.pyplot as plt

    solid = getattr(model, "solid", model)
    mesh = solid.residual.mesh()
    fig, ax = plt.subplots(1, 1)
    u = None if state is None else _host(state["u"])
    tri = triangulation(mesh, u)
    ax.triplot(tri, lw=0.4)
    ax.set_aspect("equal")
    ax.set_xlabel("x [cm]")
    ax.set_ylabel("y [cm]")
    try:
        ymid = float(_host(model.prop["ymid"])[0])
        ax.axhline(ymid, color="k", ls="--", lw=0.8)
    except (KeyError, AttributeError):
        pass
    return fig, ax


def update_figure(ax, model, state):
    """Redraw the deformed mesh on an existing axis
    (reference: ``vis/vis.py:93-130``)."""
    solid = getattr(model, "solid", model)
    mesh = solid.residual.mesh()
    for artist in list(ax.lines):
        artist.remove()
    tri = triangulation(mesh, _host(state["u"]))
    ax.triplot(tri, lw=0.4)
    return ax


def plot_gw(f, model, measure=None, ax=None):
    """Plot glottal width vs time from a statefile."""
    import matplotlib.pyplot as plt

    from ..postprocess import TimeSeries
    from ..postprocess.solid import MinGlottalWidthFromSolid

    if measure is None:
        measure = MinGlottalWidthFromSolid(model)
    gw = TimeSeries(measure)(f)
    t = f.get_times()
    if ax is None:
        _, ax = plt.subplots(1, 1)
    ax.plot(t, gw)
    ax.set_xlabel("t [s]")
    ax.set_ylabel("glottal width [cm]")
    return ax


def plot_grad(model, grad_u, ax=None):
    """Plot a gradient field over the mesh (reference: ``vis/vis.py:133-155``)."""
    import matplotlib.pyplot as plt

    solid = getattr(model, "solid", model)
    mesh = solid.residual.mesh()
    tri = triangulation(mesh)
    mag = np.linalg.norm(_host(grad_u).reshape(-1, mesh.dim), axis=-1)
    if ax is None:
        _, ax = plt.subplots(1, 1)
    tpc = ax.tripcolor(tri, mag)
    ax.figure.colorbar(tpc, ax=ax)
    ax.set_aspect("equal")
    return ax
