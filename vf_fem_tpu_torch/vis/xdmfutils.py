"""
XDMF export for ParaView (counterpart of ``vf_fem_tpu.vis.xdmfutils``;
reference: ``src/femvf/vis/xdmfutils.py``).  lxml is imported inside the
functions that write XML, so importing this module needs neither it nor
h5py; the statefile (``statefile.StateFile``) needs h5py.

The statefile stores trajectories dof-ordered and flat (``(T, ndof)``);
ParaView needs node/cell-shaped arrays.  Like the reference
(``export_mesh_values``, ``xdmfutils.py:187-308``), export first
materializes correctly-shaped datasets in the HDF5 file (an ``export/``
group): vector fields as ``(T, n_vert, 3)`` (2D components zero-padded —
ParaView renders 3-vectors), scalars as ``(T, n_vert)``, DG0 cell fields
as ``(T, n_cell)``.  ``write_xdmf`` then emits a temporal-collection XDMF
referencing one hyperslab per time row (the reference's ``XDMFArray``
hyperslab machinery, ``xdmfutils.py:38-181``).

With the framework's vertex-major interleaved dof ordering the vector
reshuffle is a pure reshape (the reference needed ``vertex_to_dof_map``
permutations).
"""

from __future__ import annotations

from os import path
from typing import Optional, Sequence

import numpy as np

_TOPOLOGY_TYPE = {2: "Triangle", 3: "Tetrahedron"}

__all__ = ["export_vertex_field", "export_mesh_values", "write_xdmf"]


def _data_item(parent, dims, text, number_type="Float", fmt="HDF",
               precision="8"):
    from lxml import etree

    item = etree.SubElement(
        parent,
        "DataItem",
        Dimensions=" ".join(str(d) for d in dims),
        NumberType=number_type,
        Precision=precision,
        Format=fmt,
    )
    item.text = text
    return item


def _hyperslab(parent, source_dims, start, stride, count, h5_path):
    """Select one time row from an exported dataset
    (reference: ``XDMFArray`` hyperslabs, ``xdmfutils.py:38-181``)."""
    from lxml import etree

    ndim = len(source_dims)
    item = etree.SubElement(
        parent,
        "DataItem",
        ItemType="HyperSlab",
        Dimensions=" ".join(str(c) for c in count),
    )
    sel = etree.SubElement(
        item, "DataItem", Dimensions=f"3 {ndim}", Format="XML"
    )
    sel.text = (
        " ".join(str(s) for s in start)
        + " "
        + " ".join(str(s) for s in stride)
        + " "
        + " ".join(str(c) for c in count)
    )
    _data_item(item, source_dims, h5_path)
    return item


def _mesh_info(statefile):
    mesh_g = statefile.root_group["mesh/solid"]
    coords = mesh_g["coordinates"]
    conn = mesh_g["connectivity"]
    dim = int(mesh_g["dim"][()])
    return coords, conn, dim


def export_vertex_field(statefile, key: str, chunk: int = 100) -> str:
    """Materialize a state trajectory field into ParaView shape.

    Vector fields (``(T, n_vert*dim)`` dof-ordered) become
    ``export/<key>`` with shape ``(T, n_vert, 3)`` (z zero-padded in 2D);
    scalar fields (``(T, n_vert)`` or ``(T, n)``) are copied as-is.
    Returns the in-file dataset path.
    """
    f = statefile
    coords, _, dim = _mesh_info(f)
    n_vert = coords.shape[0]
    src = f.root_group["state"][key]
    T, n = src.shape

    g = f.root_group.require_group("export")
    if key in g:
        del g[key]
    if n == n_vert * dim:
        dst = g.create_dataset(key, shape=(T, n_vert, 3), dtype=src.dtype)
        for s in range(0, T, chunk):
            e = min(s + chunk, T)
            block = np.zeros((e - s, n_vert, 3), dtype=src.dtype)
            block[..., :dim] = np.asarray(src[s:e]).reshape(e - s, n_vert, dim)
            dst[s:e] = block
    else:
        dst = g.create_dataset(key, data=np.asarray(src))
    return f"export/{key}"


def export_mesh_values(
    statefile,
    values: np.ndarray,
    name: str,
    center: str = "vertex",
) -> str:
    """
    Store a derived field (e.g. a postprocess measure trajectory) into the
    statefile for XDMF reference (reference: ``export_mesh_values``,
    ``xdmfutils.py:187-308``).

    ``values``: ``(T, n)`` (scalar series), ``(n,)`` (static scalar), or
    ``(T, n_vert, dim)`` (vector series).  ``center``: 'vertex' or 'cell' —
    validated against the mesh so the XDMF attribute is ParaView-valid.
    Vectors are zero-padded to 3 components.
    """
    f = statefile
    coords, conn, dim = _mesh_info(f)
    n_expect = coords.shape[0] if center == "vertex" else conn.shape[0]

    values = np.asarray(values)
    if values.ndim == 1:
        values = values[None, :]
    if values.ndim == 3:  # vector: pad to 3 comps
        if values.shape[1] != n_expect:
            raise ValueError(
                f"{name}: got {values.shape[1]} {center} values,"
                f" mesh has {n_expect}"
            )
        padded = np.zeros(values.shape[:2] + (3,), dtype=values.dtype)
        padded[..., : values.shape[2]] = values
        values = padded
    elif values.shape[1] != n_expect:
        raise ValueError(
            f"{name}: got {values.shape[1]} {center} values,"
            f" mesh has {n_expect}"
        )

    g = f.root_group.require_group("export")
    if name in g:
        del g[name]
    g.create_dataset(name, data=values)
    g[name].attrs["center"] = center
    return f"export/{name}"


def write_xdmf(
    statefile,
    xdmf_path: Optional[str] = None,
    vertex_fields: Sequence[str] = ("u", "v", "a"),
    scalar_vertex_fields: Sequence[str] = (),
    cell_fields: Sequence[str] = (),
) -> str:
    """
    Write a ParaView XDMF file for a statefile's trajectory
    (reference: ``write_xdmf``, ``xdmfutils.py:311-455``).

    ``vertex_fields`` are state keys exported as node-centred 3-vectors;
    ``scalar_vertex_fields`` as node-centred scalars; ``cell_fields`` name
    datasets previously stored by :func:`export_mesh_values` (their
    ``center`` attribute decides Node vs Cell).  Returns the XDMF path.
    """
    from lxml import etree

    f = statefile
    h5_name = path.basename(f.file.filename)
    if xdmf_path is None:
        xdmf_path = path.splitext(f.file.filename)[0] + ".xdmf"

    coords, conn, dim = _mesh_info(f)
    n_vert, n_cell = coords.shape[0], conn.shape[0]
    times = f.get_times()
    T = len(times)

    grp = f.group_name.strip("/")
    prefix = f"{h5_name}:/{grp}/" if grp else f"{h5_name}:/"

    # materialize ParaView-shaped datasets
    state_keys = set(f.root_group["state"])
    exported = {}
    for key in list(vertex_fields) + list(scalar_vertex_fields):
        if key in state_keys:
            exported[key] = export_vertex_field(f, key)

    export_g = (
        f.root_group["export"] if "export" in f.root_group else {}
    )

    # ParaView needs XYZ geometry; pad 2D coordinates once
    if dim == 2:
        g = f.root_group.require_group("export")
        if "coordinates_xyz" in g:
            del g["coordinates_xyz"]
        cz = np.zeros((n_vert, 3), dtype=np.asarray(coords).dtype)
        cz[:, :2] = np.asarray(coords)
        g.create_dataset("coordinates_xyz", data=cz)
        geom_path = f"{prefix}export/coordinates_xyz"
    else:
        geom_path = f"{prefix}mesh/solid/coordinates"

    root = etree.Element("Xdmf", Version="3.0")
    domain = etree.SubElement(root, "Domain")
    collection = etree.SubElement(
        domain,
        "Grid",
        Name="Trajectory",
        GridType="Collection",
        CollectionType="Temporal",
    )

    for n in range(T):
        grid = etree.SubElement(
            collection, "Grid", Name=f"t{n}", GridType="Uniform"
        )
        etree.SubElement(grid, "Time", Value=repr(float(times[n])))
        topo = etree.SubElement(
            grid,
            "Topology",
            TopologyType=_TOPOLOGY_TYPE[dim],
            NumberOfElements=str(n_cell),
        )
        _data_item(
            topo, conn.shape, f"{prefix}mesh/solid/connectivity",
            number_type="Int",
        )
        geom = etree.SubElement(grid, "Geometry", GeometryType="XYZ")
        _data_item(geom, (n_vert, 3), geom_path)

        for key in vertex_fields:
            if key not in exported:
                continue
            attr = etree.SubElement(
                grid,
                "Attribute",
                Name=key,
                AttributeType="Vector",
                Center="Node",
            )
            _hyperslab(
                attr,
                (T, n_vert, 3),
                (n, 0, 0),
                (1, 1, 1),
                (1, n_vert, 3),
                f"{prefix}{exported[key]}",
            )
        for key in scalar_vertex_fields:
            if key not in exported:
                continue
            src_dims = f.root_group[exported[key]].shape
            attr = etree.SubElement(
                grid,
                "Attribute",
                Name=key,
                AttributeType="Scalar",
                Center="Node",
            )
            _hyperslab(
                attr, src_dims, (n, 0), (1, 1), (1, src_dims[1]),
                f"{prefix}{exported[key]}",
            )
        for key in cell_fields:
            if key not in export_g:
                continue
            ds = export_g[key]
            center = ds.attrs.get("center", "cell")
            is_vec = ds.ndim == 3
            attr = etree.SubElement(
                grid,
                "Attribute",
                Name=key,
                AttributeType="Vector" if is_vec else "Scalar",
                Center="Node" if center == "vertex" else "Cell",
            )
            row = min(n, ds.shape[0] - 1)  # static fields: 1 row
            if is_vec:
                _hyperslab(
                    attr, ds.shape, (row, 0, 0), (1, 1, 1),
                    (1, ds.shape[1], 3), f"{prefix}export/{key}",
                )
            else:
                _hyperslab(
                    attr, ds.shape, (row, 0), (1, 1), (1, ds.shape[1]),
                    f"{prefix}export/{key}",
                )

    tree = etree.ElementTree(root)
    tree.write(
        xdmf_path, pretty_print=True, xml_declaration=True, encoding="utf-8"
    )
    return xdmf_path
