"""
M5 meshes built once and kept as ``.msh`` files (``vf_fem_tpu_torch/_build/``,
beside the built kernels): the numpy mesher takes minutes at the large
sizes (``M5_3layers`` at h = 0.003 cm, 47,405 vertices), so only the first
use on a machine builds.  With ``nz >= 2`` the profile is extruded to a
tetrahedral mesh through ``nz`` z-planes spread over ``[0, zlen]``
(``extrude.extrude_mesh``, as ``benchmarks/benchmark_large.py:24-51``
builds its ``--extrude`` meshes; one fluid channel a plane).

    python -m vf_fem_tpu_torch.mesh.cached [--h 0.003] [--smooth-iters 10] [--extrude NZ] [--zlen 1.5]

builds (or finds) the cache and prints its path and the meshing time.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np

from .extrude import extrude_mesh
from .gmsh_io import load_gmsh
from .m5 import m5_mesh
from .reorder import rcm_mesh
from .writers import write_gmsh

CACHE_DIR = Path(__file__).resolve().parents[1] / "_build"


def extrusion_planes(nz: int, zlen: float = 1.5) -> np.ndarray:
    """The z-planes of an extruded mesh (and of its fluid channels)."""
    return np.linspace(0.0, zlen, nz)


def m5_cache_path(name: str = "M5_3layers", h: float = 0.003, smooth_iters: int = 10,
                  cache_dir=CACHE_DIR, nz: int = 0, zlen: float = 1.5) -> Path:
    """Where :func:`cached_m5_mesh` keeps the RCM-ordered mesh (its name
    carries ``nz`` and ``zlen`` where it is extruded)."""
    tag = f"_nz{nz}_z{zlen:g}" if nz else ""
    return Path(cache_dir) / f"{name}_h{h:g}_s{smooth_iters}{tag}_rcm.msh"


def cached_m5_mesh(name: str = "M5_3layers", h: float = 0.003, smooth_iters: int = 10,
                   cache_dir=CACHE_DIR, nz: int = 0, zlen: float = 1.5):
    """``m5_mesh(name, h, smooth_iters)``, extruded through
    ``extrusion_planes(nz, zlen)`` where ``nz`` is given, renumbered by
    reverse Cuthill-McKee (``reorder.rcm_mesh``, as
    ``benchmarks/benchmark_large.py`` meshes its large sizes), read from
    its ``.msh`` cache, which is written first where it is missing
    (atomically: a process that finds the file finds it whole).  Returns
    ``(path, seconds)``: ``seconds`` is the time the meshing took, None
    where the cache was there."""
    path = m5_cache_path(name, h, smooth_iters, cache_dir, nz, zlen)
    if path.exists():
        return path, None
    t0 = time.perf_counter()
    mesh = m5_mesh(name, h=h, smooth_iters=smooth_iters)
    if nz:
        mesh = extrude_mesh(mesh, extrusion_planes(nz, zlen))
    mesh = rcm_mesh(mesh)
    seconds = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".msh", dir=path.parent)
    os.close(fd)
    try:
        write_gmsh(mesh, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, seconds


def load_cached_m5_mesh(name: str = "M5_3layers", h: float = 0.003, smooth_iters: int = 10,
                        cache_dir=CACHE_DIR, nz: int = 0, zlen: float = 1.5):
    """The cached mesh (built where missing) as a :class:`~.core.Mesh`, read
    back from its file whether or not it was just built, so that every
    use sees the same mesh; returns ``(mesh, seconds)`` as
    :func:`cached_m5_mesh`."""
    path, seconds = cached_m5_mesh(name, h, smooth_iters, cache_dir, nz, zlen)
    return load_gmsh(str(path)), seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--name", default="M5_3layers")
    ap.add_argument("--h", type=float, default=0.003)
    ap.add_argument("--smooth-iters", type=int, default=10)
    ap.add_argument("--extrude", type=int, default=0, metavar="NZ",
                    help="z-planes of a 3D extrusion (0: the 2D mesh)")
    ap.add_argument("--zlen", type=float, default=1.5)
    args = ap.parse_args()
    path, seconds = cached_m5_mesh(args.name, args.h, args.smooth_iters,
                                   nz=args.extrude, zlen=args.zlen)
    print(f"{path} {'cached' if seconds is None else f'meshed in {seconds:.1f} s'}",
          flush=True)


if __name__ == "__main__":
    main()
