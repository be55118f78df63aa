"""
Minimal STEP (ISO 10303-21, AP214) reader for planar vocal-fold profiles.

The reference ships its M5 (Scherer) vocal-fold geometries as SolidWorks
STEP exports (reference ``meshes/stp/M5_CB_GA{0..3}[_split].STEP`` and
``meshes/geometries/M5-3layers*.STEP``) and meshes them with gmsh's OCC
kernel (reference ``meshes/genmesh_M5_CB.py:10-66``).  Neither gmsh nor an
OCC kernel is a dependency of this package, so this module parses the (tiny,
text) STEP files directly: planar ``ADVANCED_FACE``s bounded by
``EDGE_LOOP``s of ``LINE`` and ``CIRCLE`` edges.

Output is purely geometric host-side data: per-face closed polygons whose
edges carry their originating STEP entity ids, so shared body/cover
interface edges are discretized once and the meshing step (triangulate.py)
produces a conforming multi-material mesh.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["StepEdge", "StepFace", "read_step_profile", "discretize_edge"]


# ---------------------------------------------------------------------------
# ISO 10303-21 entity parsing
# ---------------------------------------------------------------------------

def _read_data_section(text: str) -> dict:
    """Map entity id -> (TYPE, raw argument string)."""
    data = text.split("DATA;", 1)[1].split("ENDSEC;", 1)[0]
    # join continued lines: entities end with ';'
    entities = {}
    for stmt in data.split(";"):
        stmt = stmt.strip()
        if not stmt.startswith("#"):
            continue
        m = re.match(r"#(\d+)\s*=\s*([A-Z_0-9]+)\s*\((.*)\)\s*$", stmt, re.S)
        if not m:
            continue
        eid, etype, args = int(m.group(1)), m.group(2), m.group(3)
        entities[eid] = (etype, args)
    return entities


def _tokenize_args(args: str) -> list:
    """Parse a STEP argument list into python values.

    Handles strings, entity refs (#n -> int), enums (.T. -> True etc.),
    numbers, '*' placeholders, and nested parenthesized lists.
    """
    tokens = []
    i, n = 0, len(args)
    while i < n:
        c = args[i]
        if c in ", \t\n\r":
            i += 1
        elif c == "(":
            depth, j = 1, i + 1
            while depth:
                if args[j] == "(":
                    depth += 1
                elif args[j] == ")":
                    depth -= 1
                j += 1
            tokens.append(_tokenize_args(args[i + 1 : j - 1]))
            i = j
        elif c == "'":
            j = args.index("'", i + 1)
            tokens.append(args[i + 1 : j])
            i = j + 1
        elif c == "#":
            m = re.match(r"#(\d+)", args[i:])
            tokens.append(("#", int(m.group(1))))
            i += m.end()
        elif c == ".":
            m = re.match(r"\.([A-Z_]+)\.", args[i:])
            val = m.group(1)
            tokens.append({"T": True, "F": False}.get(val, val))
            i += m.end()
        elif c == "*" or c == "$":
            tokens.append(None)
            i += 1
        elif c.isalpha() or c == "_":
            # typed value, e.g. LENGTH_MEASURE( 1.0E-05 ): keep the tag,
            # the following parenthesized payload is parsed as a list
            m = re.match(r"[A-Za-z_][A-Za-z_0-9]*", args[i:])
            tokens.append(m.group(0))
            i += m.end()
        else:
            m = re.match(r"[-+0-9.Ee]+", args[i:])
            s = m.group(0)
            tokens.append(float(s) if any(ch in s for ch in ".Ee") else int(s))
            i += m.end()
    return tokens


@dataclass
class StepEdge:
    """One B-rep edge: endpoints plus LINE/CIRCLE geometry."""

    eid: int
    p0: np.ndarray  # (2,) start point
    p1: np.ndarray  # (2,) end point
    kind: str  # 'line' | 'circle'
    center: Optional[np.ndarray] = None
    radius: float = 0.0
    ccw: bool = True  # traversal sense p0 -> p1 about +z


@dataclass
class StepFace:
    """A planar face: ordered closed loop of (edge, flipped) pairs."""

    fid: int
    loop: list = field(default_factory=list)  # [(StepEdge, bool flipped)]

    def polygon(self, max_seg: float = 0.02) -> np.ndarray:
        """Closed polygon (n, 2), arcs sampled at chord length max_seg."""
        pts = []
        for edge, flipped in self.loop:
            seg = discretize_edge(edge, max_seg)
            if flipped:
                seg = seg[::-1]
            pts.append(seg[:-1])
        return np.concatenate(pts, axis=0)


def discretize_edge(edge: StepEdge, max_seg: float = 0.02) -> np.ndarray:
    """Sample an edge into points (m, 2) from p0 to p1 inclusive."""
    if edge.kind == "line":
        return np.stack([edge.p0, edge.p1], axis=0)
    # circle arc
    c, r = edge.center, edge.radius
    a0 = np.arctan2(edge.p0[1] - c[1], edge.p0[0] - c[0])
    a1 = np.arctan2(edge.p1[1] - c[1], edge.p1[0] - c[0])
    if edge.ccw:
        sweep = (a1 - a0) % (2 * np.pi)
    else:
        sweep = -((a0 - a1) % (2 * np.pi))
    if sweep == 0.0:
        sweep = 2 * np.pi if edge.ccw else -2 * np.pi
    arclen = abs(sweep) * r
    m = max(2, int(np.ceil(arclen / max_seg)) + 1)
    angles = a0 + sweep * np.linspace(0.0, 1.0, m)
    pts = c[None, :] + r * np.stack(
        [np.cos(angles), np.sin(angles)], axis=1
    )
    pts[0] = edge.p0
    pts[-1] = edge.p1
    return pts


def read_step_profile(path: str) -> list:
    """Read a planar STEP B-rep into a list of :class:`StepFace`.

    Only the entity subset used by the reference's SolidWorks exports is
    supported (LINE, CIRCLE on the z=0 plane).  Faces are returned in file
    entity-id order (gmsh's OCC import numbers them the same way, which is
    what the reference's physical-group assignments index,
    reference ``meshes/genmesh_M5_CB.py:20-32``).
    """
    with open(path) as f:
        entities = _read_data_section(f.read())

    parsed = {eid: (t, _tokenize_args(a)) for eid, (t, a) in entities.items()}

    def ref(tok):
        return tok[1]

    def point2(eid):
        t, args = parsed[eid]
        xyz = args[1]
        return np.asarray(xyz[:2], dtype=float)

    def direction3(eid):
        t, args = parsed[eid]
        return np.asarray(args[1], dtype=float)

    edges = {}

    def get_edge(eid):
        if eid in edges:
            return edges[eid]
        t, args = parsed[eid]
        assert t == "EDGE_CURVE", t
        v0, v1, curve, same_sense = (
            ref(args[1]), ref(args[2]), ref(args[3]), args[4],
        )
        p0 = point2(ref(parsed[v0][1][1]))
        p1 = point2(ref(parsed[v1][1][1]))
        ct, cargs = parsed[curve]
        if ct == "LINE":
            edge = StepEdge(eid, p0, p1, "line")
        elif ct == "CIRCLE":
            placement = ref(cargs[1])
            radius = float(cargs[2])
            pt, pargs = parsed[placement]
            center = point2(ref(pargs[1]))
            axis = direction3(ref(pargs[2]))
            # circle parametrized CCW about its axis; axis is +/- z here
            ccw = axis[2] >= 0
            if not same_sense:
                ccw = not ccw
            edge = StepEdge(eid, p0, p1, "circle", center, radius, ccw)
        else:  # pragma: no cover - unsupported curve type
            raise ValueError(f"unsupported STEP curve {ct} (#{curve})")
        edges[eid] = edge
        return edge

    faces = []
    for eid in sorted(parsed):
        t, args = parsed[eid]
        if t != "ADVANCED_FACE":
            continue
        bounds = args[1]
        loop_edges = []
        for b in bounds:
            bt, bargs = parsed[ref(b)]
            loop_eid = ref(bargs[1])
            bound_sense = bargs[2]
            lt, largs = parsed[loop_eid]
            assert lt == "EDGE_LOOP", lt
            for oe in largs[1]:
                ot, oargs = parsed[ref(oe)]
                assert ot == "ORIENTED_EDGE", ot
                edge = get_edge(ref(oargs[3]))
                flipped = not oargs[4]
                if not bound_sense:
                    flipped = not flipped
                loop_edges.append((edge, flipped))
            if not bound_sense:
                loop_edges.reverse()
        faces.append(StepFace(eid, loop_edges))
    return faces
