"""
M5 (Scherer) vocal-fold meshes from the extracted CAD profiles.

The reference meshes its M5 STEP exports with gmsh, tagging physical
groups 'body'/'cover' (surfaces), 'pressure'/'fixed' (curves) and
'separation-inf/mid/sup' (points) (reference
``meshes/genmesh_M5_CB.py:10-66``).  Here the same geometries — the four
medial-angle body/cover profiles, their split-cover variants, and the
3-layer profile — are rebuilt from the committed B-rep control data
(:mod:`._m5_data`, extracted from the reference CAD by
``meshes/extract_m5_profiles.py``) and triangulated with the in-repo
mesher (:mod:`.triangulate`).

Group semantics are assigned geometrically rather than by gmsh's OCC
entity numbering:

- regions: the face whose bounding box is innermost is 'body'; in the
  3-layer profile the middle face is 'ligament'; everything outer is
  'cover' (split geometries map both split faces to 'cover', matching
  ``genmesh_M5_CB.py:48-49``).
- 'fixed': exterior straight edges lying on y=0 (the attachment plane);
- 'pressure': every other exterior edge (the air-facing contour);
- separation points: the junction vertices bounding (and inside, for
  split profiles) the superior rounded-edge arc run — the downstream end
  of the medial surface, i.e. the candidate flow-separation locations the
  reference labels 'separation-inf/mid/sup' (``genmesh_M5_CB.py:27-28``
  and ``:53-55``).
"""

from __future__ import annotations

import numpy as np

from ._m5_data import M5_PROFILES
from .core import Mesh
from .step_io import StepEdge
from .triangulate import triangulate_regions

__all__ = ["m5_mesh", "m5_profile_names"]

_YTOL = 1e-9


def m5_profile_names() -> list:
    return sorted(M5_PROFILES.keys())


def _decode(profile: dict):
    edges = {}
    for eid, rec in profile["edges"].items():
        kind = rec[0]
        p0 = np.asarray(rec[1], dtype=float)
        p1 = np.asarray(rec[2], dtype=float)
        if kind == "line":
            edges[eid] = StepEdge(eid, p0, p1, "line")
        else:
            center = np.asarray(rec[3], dtype=float)
            edges[eid] = StepEdge(
                eid, p0, p1, "circle", center, float(rec[4]), bool(rec[5])
            )
    loops = [
        [(edges[eid], bool(fl)) for eid, fl in loop]
        for loop in profile["faces"]
    ]
    return edges, loops


def _loop_ymax(loop) -> float:
    return max(max(e.p0[1], e.p1[1]) for e, _ in loop)


def _region_names(loops) -> list:
    """body = innermost (smallest max-y).

    Three-face profiles are either nested layers (body/ligament/cover,
    the 3-layer geometry: adjacent layers share edges but body and the
    outermost face do not) or a split cover (two cover faces both
    touching the body, reference ``genmesh_M5_CB.py:48-49``)."""
    ymaxs = [_loop_ymax(lp) for lp in loops]
    order = np.argsort(ymaxs)
    names = ["cover"] * len(loops)
    names[order[0]] = "body"
    if len(loops) == 3:
        body_eids = {e.eid for e, _ in loops[order[0]]}
        outer_eids = {e.eid for e, _ in loops[order[2]]}
        if not (body_eids & outer_eids):
            names[order[1]] = "ligament"  # nested layers, no body contact
    return names


def _exterior_chain(loops):
    """Ordered exterior boundary walk as a list of (edge, flipped),
    starting at the leftmost bottom vertex and ending back there."""
    counts = {}
    for lp in loops:
        for e, _ in lp:
            counts[e.eid] = counts.get(e.eid, 0) + 1
    ext = {}
    for lp in loops:
        for e, fl in lp:
            if counts[e.eid] == 1:
                ext[e.eid] = (e, fl)

    def key(p):
        return (round(float(p[0]), 9), round(float(p[1]), 9))

    start_of = {}
    for e, fl in ext.values():
        p_start = e.p1 if fl else e.p0
        start_of[key(p_start)] = (e, fl)

    # start at the leftmost vertex on y=0 (the subglottal corner)
    pts = [e.p0 for e, _ in ext.values()] + [e.p1 for e, _ in ext.values()]
    pts = np.asarray(pts)
    onfloor = pts[np.abs(pts[:, 1]) < _YTOL]
    start = onfloor[np.argmin(onfloor[:, 0])]

    chain = []
    cur = key(start)
    for _ in range(len(ext)):
        e, fl = start_of[cur]
        chain.append((e, fl))
        p_end = e.p0 if fl else e.p1
        cur = key(p_end)
    assert cur == key(start), "exterior boundary is not a single closed loop"
    return chain


def _classify_groups(loops):
    """Facet groups (pressure/fixed) + separation vertex coordinates."""
    chain = _exterior_chain(loops)

    def on_floor(e):
        return (
            e.kind == "line"
            and abs(e.p0[1]) < _YTOL
            and abs(e.p1[1]) < _YTOL
        )

    fixed = [e.eid for e, _ in chain if on_floor(e)]
    pressure_chain = [(e, fl) for e, fl in chain if not on_floor(e)]
    pressure = [e.eid for e, _ in pressure_chain]

    # orient the pressure walk upstream -> downstream (increasing x)
    first = pressure_chain[0]
    last = pressure_chain[-1]

    def startpt(e, fl):
        return e.p1 if fl else e.p0

    if startpt(*first)[0] > startpt(*last)[0]:
        pressure_chain = [(e, not fl) for e, fl in reversed(pressure_chain)]

    # superior rounded edge = last run of circle edges along the walk
    runs = []
    cur = []
    for e, fl in pressure_chain:
        if e.kind == "circle":
            cur.append((e, fl))
        else:
            if cur:
                runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    seps = {}
    if runs:
        arc_run = runs[-1]
        junctions = [startpt(*arc_run[0])]
        for e, fl in arc_run:
            junctions.append(e.p0 if fl else e.p1)
        if len(junctions) == 2:
            seps["separation-inf"] = junctions[0]
            seps["separation-sup"] = junctions[1]
        else:
            seps["separation-inf"] = junctions[0]
            for i, p in enumerate(junctions[1:-1]):
                name = "separation-mid" + ("" if i == 0 else f"-{i}")
                seps[name] = p
            seps["separation-sup"] = junctions[-1]
    return {"pressure": pressure, "fixed": fixed}, seps


def m5_mesh(name: str = "M5_CB_GA3", h: float = 0.03,
            smooth_iters: int = 25) -> Mesh:
    """Build a tagged triangle mesh of an M5 profile.

    ``name``: one of ``M5_CB_GA{0..3}``, ``M5_CB_GA{0..3}_split``,
    ``M5_3layers``.  ``h``: target element size in cm (the profiles are
    ~0.8 cm wide).
    """
    if name not in M5_PROFILES:
        raise KeyError(
            f"unknown M5 profile {name!r}; available: {m5_profile_names()}"
        )
    _, loops = _decode(M5_PROFILES[name])
    names = _region_names(loops)
    facet_groups, vertex_groups = _classify_groups(loops)
    # body first so its cells come first (cosmetic, matches gmsh output)
    order = np.argsort([{"body": 0, "ligament": 1}.get(n, 2) for n in names])
    regions = [(names[i], loops[i]) for i in order]
    return triangulate_regions(
        regions, h, facet_groups, vertex_groups, smooth_iters
    )
