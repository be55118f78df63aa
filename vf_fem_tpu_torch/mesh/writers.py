"""
Gmsh ``.msh`` (v2.2 ASCII) writer.

The reference generates meshes with gmsh from STEP CAD files
(reference: ``meshes/genmesh_M5_CB.py``); without gmsh in this environment
the generators in :mod:`.primitives` and :mod:`.m5` produce meshes directly,
and this writer persists them as standard ``.msh`` files (readable by this
package's parser, gmsh, and meshio alike).
"""

from __future__ import annotations

from .core import Mesh

# element type codes per dimension-of-entity and vertex count
_TYPE_BY_NV = {1: 15, 2: 1, 3: 2, 4: 4}


def write_gmsh(mesh: Mesh, path: str):
    """Write a mesh (with markers/subdomain names) as MSH 2.2 ASCII."""
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat"]

    # physical names
    names = []
    for d, sub in mesh.subdomains.items():
        for name, marker in sub.items():
            if marker != 0:
                names.append((d, marker, name))
    if names:
        lines.append("$PhysicalNames")
        lines.append(str(len(names)))
        for d, marker, name in names:
            lines.append(f'{d} {marker} "{name}"')
        lines.append("$EndPhysicalNames")

    # nodes (1-based)
    coords = mesh.coords
    lines.append("$Nodes")
    lines.append(str(coords.shape[0]))
    for i, xy in enumerate(coords):
        x = float(xy[0])
        y = float(xy[1]) if coords.shape[1] > 1 else 0.0
        z = float(xy[2]) if coords.shape[1] > 2 else 0.0
        lines.append(f"{i + 1} {x!r} {y!r} {z!r}")
    lines.append("$EndNodes")

    # elements: all marked entities of every dimension + all cells
    elems = []
    for d, ents in mesh.entities.items():
        markers = mesh.mesh_functions[d]
        for ei in range(ents.shape[0]):
            m = int(markers[ei])
            is_cell = d == mesh.dim
            if m == 0 and not is_cell:
                continue
            verts = ents[ei]
            etype = _TYPE_BY_NV[len(verts)]
            elems.append((etype, m, verts))

    lines.append("$Elements")
    lines.append(str(len(elems)))
    for i, (etype, m, verts) in enumerate(elems):
        vs = " ".join(str(v + 1) for v in verts)
        lines.append(f"{i + 1} {etype} 2 {m} {m} {vs}")
    lines.append("$EndElements")

    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    return path
