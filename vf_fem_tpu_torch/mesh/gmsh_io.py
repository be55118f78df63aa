"""
Pure-python gmsh ``.msh`` reader (ASCII v2.2 and v4.1).

The reference reads gmsh meshes through meshio + dolfin XDMF side-files
(reference: ``src/femvf/meshutils.py:63-166``).  Neither is available (or
needed) here; this standalone parser extracts nodes, elements and physical
groups and produces a :class:`~vf_fem_tpu_torch.mesh.core.Mesh` with per-dimension
markers and subdomain-name dicts, replicating ``load_fenics_gmsh`` semantics
including the automatic z-trim for planar meshes.
"""

from __future__ import annotations

import numpy as np

from .core import INT, Mesh

# gmsh element type -> (dim, n_nodes)
_ELEMENT_TYPES = {
    15: (0, 1),  # point
    1: (1, 2),  # line
    2: (2, 3),  # triangle
    4: (3, 4),  # tetrahedron
}


def _read_sections(path: str) -> dict:
    sections = {}
    with open(path, "r") as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            body = []
            end = f"$End{name}"
            while j < len(lines) and lines[j].strip() != end:
                body.append(lines[j])
                j += 1
            sections[name] = body
            i = j + 1
        else:
            i += 1
    return sections


def _parse_physical_names(body):
    names = {}  # (dim, tag) -> name
    if not body:
        return names
    n = int(body[0])
    for line in body[1 : 1 + n]:
        parts = line.split()
        dim, tag = int(parts[0]), int(parts[1])
        name = " ".join(parts[2:]).strip().strip('"')
        names[(dim, tag)] = name
    return names


def _parse_v2(sections):
    node_lines = sections["Nodes"]
    n_nodes = int(node_lines[0])
    tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    for i, line in enumerate(node_lines[1 : 1 + n_nodes]):
        parts = line.split()
        tags[i] = int(parts[0])
        coords[i] = [float(x) for x in parts[1:4]]

    elem_lines = sections["Elements"]
    n_elems = int(elem_lines[0])
    elements = []  # (dim, physical_tag, node_tags)
    for line in elem_lines[1 : 1 + n_elems]:
        parts = [int(x) for x in line.split()]
        etype = parts[1]
        if etype not in _ELEMENT_TYPES:
            continue
        dim, n_en = _ELEMENT_TYPES[etype]
        ntags = parts[2]
        phys = parts[3] if ntags >= 1 else 0
        nodes = parts[3 + ntags :]
        assert len(nodes) == n_en
        elements.append((dim, phys, nodes))
    return tags, coords, elements


def _parse_v4(sections):
    # Entity tag -> physical tags
    entity_phys = {}  # (dim, entity_tag) -> physical tag (first)
    if "Entities" in sections:
        body = sections["Entities"]
        counts = [int(x) for x in body[0].split()]
        idx = 1
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = body[idx].split()
                idx += 1
                tag = int(parts[0])
                if dim == 0:
                    n_phys = int(parts[4])
                    phys = [int(p) for p in parts[5 : 5 + n_phys]]
                else:
                    n_phys = int(parts[7])
                    phys = [int(p) for p in parts[8 : 8 + n_phys]]
                entity_phys[(dim, tag)] = phys[0] if phys else 0

    node_body = sections["Nodes"]
    header = [int(x) for x in node_body[0].split()]
    n_blocks, n_nodes = header[0], header[1]
    tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    idx, out = 1, 0
    for _ in range(n_blocks):
        _, _, _, n_in_block = (int(x) for x in node_body[idx].split())
        idx += 1
        block_tags = [int(node_body[idx + i]) for i in range(n_in_block)]
        idx += n_in_block
        for i in range(n_in_block):
            parts = node_body[idx + i].split()
            tags[out + i] = block_tags[i]
            coords[out + i] = [float(x) for x in parts[:3]]
        idx += n_in_block
        out += n_in_block

    elem_body = sections["Elements"]
    header = [int(x) for x in elem_body[0].split()]
    n_blocks = header[0]
    idx = 1
    elements = []
    for _ in range(n_blocks):
        ent_dim, ent_tag, etype, n_in_block = (
            int(x) for x in elem_body[idx].split()
        )
        idx += 1
        phys = entity_phys.get((ent_dim, ent_tag), 0)
        if etype in _ELEMENT_TYPES:
            dim, n_en = _ELEMENT_TYPES[etype]
            for i in range(n_in_block):
                parts = [int(x) for x in elem_body[idx + i].split()]
                elements.append((dim, phys, parts[1 : 1 + n_en]))
        idx += n_in_block
    return tags, coords, elements


def load_gmsh(path: str) -> Mesh:
    """
    Read a gmsh ``.msh`` file into a :class:`Mesh` with markers/subdomains.

    Mirrors ``load_fenics_gmsh`` (reference: ``src/femvf/meshutils.py:63-166``):
    the cell dimension is the max element dimension found; planar meshes are
    trimmed to 2D; physical groups become per-dimension marker functions and
    name->marker dicts.
    """
    sections = _read_sections(path)
    version = sections.get("MeshFormat", ["2.2"])[0].split()[0]
    names = _parse_physical_names(sections.get("PhysicalNames", []))

    if version.startswith("2"):
        tags, coords, elements = _parse_v2(sections)
    else:
        tags, coords, elements = _parse_v4(sections)

    tag_to_idx = {int(t): i for i, t in enumerate(tags)}
    top_dim = max(dim for dim, _, _ in elements)

    # z-trim for planar meshes
    if top_dim == 2 and np.allclose(coords[:, 2], coords[0, 2]):
        coords = coords[:, :2]
    else:
        coords = coords[:, :top_dim] if top_dim == 3 else coords

    cells = np.array(
        [
            [tag_to_idx[t] for t in nodes]
            for dim, _, nodes in elements
            if dim == top_dim
        ],
        dtype=INT,
    )
    mesh = Mesh(coords, cells)

    # Assign markers per dimension by matching sorted vertex tuples
    for d in range(top_dim + 1):
        tagged = [
            (phys, [tag_to_idx[t] for t in nodes])
            for dim, phys, nodes in elements
            if dim == d and phys != 0
        ]
        if not tagged:
            continue
        ents = mesh.entities.get(d)
        if ents is None:
            continue
        # map sorted tuple -> entity index
        lookup = {tuple(sorted(e)): i for i, e in enumerate(ents.tolist())}
        for phys, nodes in tagged:
            key = tuple(sorted(nodes))
            if key in lookup:
                mesh.mesh_functions[d][lookup[key]] = phys

    # Subdomain name dicts
    for (dim, tag), name in names.items():
        if dim <= top_dim:
            mesh.subdomains.setdefault(dim, {})[name] = tag

    return mesh
