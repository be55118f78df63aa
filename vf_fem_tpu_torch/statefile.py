"""
HDF5 time-history state files (counterpart of ``vf_fem_tpu.statefile``),
with the JAX package's schema, so that a file written by either package
reads in the other:

- ``time``: (T,) float64, chunked ``(NCHUNK,)``
- ``meas_indices``: (M,) int64
- ``mesh/solid/{coordinates, connectivity, dim}``
- ``dofmap/{CG1, scalar, vector}``: vertex -> scalar dof, cell scalar and
  vector dofs (vertex-major interleaved ordering)
- ``state/{u,v,a,q,p}``: (T, ndof) float64, chunked ``(NCHUNK, ndof)``
- ``control/*``: (T_c, n) float64, chunked ``(NCHUNK, n)``
- ``properties/*``: (n,)
- ``solver_info/{num_iter, abs_err, rel_err}``: (T,) float64

Rows are dicts of numpy arrays (or tensors, copied to the host), in the
model's key order (``model.state0``, ``model.control``, ``model.prop``).
The forward loop appends whole trajectory windows at once
(:meth:`StateFile.append_window`); a small cache of chunk rows serves
repeated and reverse-order row reads.

h5py is imported when a :class:`StateFile` is opened, not with this
module: ``forward`` and a run without a statefile need none.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

NCHUNK = 100
INFO_KEYS = ("num_iter", "abs_err", "rel_err")


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


class DatasetChunkCache:
    """LRU cache of chunk rows for fast repeated and reverse row reads."""

    def __init__(self, dataset, num_chunks: int = 2):
        self.dataset = dataset
        self.chunk_rows = dataset.chunks[0] if dataset.chunks else NCHUNK
        self.num_chunks = num_chunks
        self.cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self.reads = 0  # chunk reads from the file

    def get(self, m: int) -> np.ndarray:
        m_chunk = m // self.chunk_rows
        if m_chunk in self.cache:
            self.cache.move_to_end(m_chunk)
        else:
            start = m_chunk * self.chunk_rows
            stop = min(start + self.chunk_rows, self.dataset.shape[0])
            self.cache[m_chunk] = self.dataset[start:stop][:]
            self.reads += 1
            if len(self.cache) > self.num_chunks:
                self.cache.popitem(last=False)
        return self.cache[m_chunk][m % self.chunk_rows]


class StateFile:
    """HDF5 history of a transient run.

    ``model`` gives the state, control and property layouts (its
    ``state0``, ``control`` and ``prop`` dicts) and the mesh; ``fname`` is
    the file's path, opened in ``mode`` (h5py's modes); the run is stored
    under ``group``.
    """

    def __init__(self, model, fname: str, mode: str = "r", group: str = "/",
                 NCHUNK: int = NCHUNK, **kwargs):
        import h5py

        self.model = model
        self.file = h5py.File(fname, mode=mode, **kwargs)
        self.group_name = group
        self.NCHUNK = NCHUNK
        if group not in self.file:
            self.file.require_group(group)
        self.root_group = self.file[group]
        self._caches: dict = {}

    # -- context manager -------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    def close(self):
        self.file.close()

    def __len__(self):
        return self.size

    @property
    def size(self) -> int:
        """Number of stored time points."""
        if "time" in self.root_group:
            return self.root_group["time"].shape[0]
        return 0

    @property
    def num_states(self) -> int:
        return self.size

    # -- layout ------------------------------------------------------------------
    def init_layout(self):
        """Create every dataset that does not exist yet."""
        g = self.root_group
        if "time" not in g:
            g.create_dataset("time", (0,), maxshape=(None,), chunks=(self.NCHUNK,),
                             dtype=np.float64)
        if "meas_indices" not in g:
            g.create_dataset("meas_indices", (0,), maxshape=(None,), dtype=np.int64)
        self.init_mesh()
        self.init_state()
        self.init_control()
        self.init_solver_info()

    def init_mesh(self):
        g = self.root_group
        solid = getattr(self.model, "solid", None)
        if solid is None or "mesh" in g:
            return
        mesh = solid.residual.mesh()
        mg = g.require_group("mesh/solid")
        mg.create_dataset("coordinates", data=mesh.coords)
        mg.create_dataset("connectivity", data=np.asarray(mesh.cells))
        mg.create_dataset("dim", data=mesh.dim)
        dg = g.require_group("dofmap")
        # vertex-major ordering: scalar CG1 dof == vertex index, scalar cell
        # dofs == the connectivity rows, vector dof = vertex * dim + comp
        dg.create_dataset("CG1", data=np.arange(mesh.num_vertices, dtype=np.int64))
        cells = np.asarray(mesh.cells, dtype=np.int64)
        dg.create_dataset("scalar", data=cells)
        vec = (cells[:, :, None] * mesh.dim
               + np.arange(mesh.dim, dtype=np.int64)[None, None, :]
               ).reshape(cells.shape[0], -1)
        dg.create_dataset("vector", data=vec)

    def _init_group_like(self, name: str, layout: dict):
        g = self.root_group.require_group(name)
        for key, vec in layout.items():
            if key not in g:
                n = np.asarray(vec).size
                g.create_dataset(key, (0, n), maxshape=(None, n),
                                 chunks=(self.NCHUNK, n), dtype=np.float64)

    def init_state(self):
        self._init_group_like("state", self.model.state0)

    def init_control(self):
        self._init_group_like("control", self.model.control)

    def init_solver_info(self):
        g = self.root_group.require_group("solver_info")
        for key in INFO_KEYS:
            if key not in g:
                g.create_dataset(key, (0,), maxshape=(None,), chunks=(self.NCHUNK,),
                                 dtype=np.float64)

    # -- append ------------------------------------------------------------------
    @staticmethod
    def _append_rows(dset, rows: np.ndarray):
        rows = np.atleast_1d(rows)
        n0 = dset.shape[0]
        dset.resize(n0 + rows.shape[0], axis=0)
        dset[n0:] = rows

    def _append_row(self, name: str, row: dict):
        g = self.root_group[name]
        for key, vec in row.items():
            self._append_rows(g[key], _host(vec).reshape(1, -1))

    def append_state(self, state: dict):
        self._append_row("state", state)

    def append_control(self, control: dict):
        self._append_row("control", control)

    def append_time(self, time: float):
        self._append_rows(self.root_group["time"], np.array([time]))

    def append_meas_index(self, index: int):
        self._append_rows(self.root_group["meas_indices"],
                          np.array([index], dtype=np.int64))

    def append_solver_info(self, info: dict):
        g = self.root_group["solver_info"]
        for key in INFO_KEYS:
            self._append_rows(g[key], np.array([float(info.get(key, np.nan))]))

    def append_prop(self, prop: dict):
        g = self.root_group.require_group("properties")
        for key, vec in prop.items():
            if key not in g:
                g.create_dataset(key, data=_host(vec))

    def append_window(self, states: dict, controls: dict, times: np.ndarray,
                      solver_info: dict):
        """Append a trajectory window at once: ``states[key]`` and
        ``controls[key]`` of shape ``(T, n)``, ``times`` and each of
        ``solver_info``'s ``num_iter``, ``abs_err``, ``rel_err`` of ``(T,)``."""
        sg = self.root_group["state"]
        for key, arr in states.items():
            self._append_rows(sg[key], _host(arr))
        cg = self.root_group["control"]
        for key, arr in controls.items():
            self._append_rows(cg[key], _host(arr))
        self._append_rows(self.root_group["time"], _host(times))
        ig = self.root_group["solver_info"]
        for key in INFO_KEYS:
            self._append_rows(ig[key], _host(solver_info[key]).astype(np.float64))

    # -- read ------------------------------------------------------------------------
    def _row_cache(self, path: str) -> DatasetChunkCache:
        if path not in self._caches:
            self._caches[path] = DatasetChunkCache(self.root_group[path])
        return self._caches[path]

    def get_state(self, n: int) -> dict:
        n = int(n) % max(self.size, 1) if n < 0 else int(n)
        return {k: self._row_cache(f"state/{k}").get(n) for k in self.model.state0}

    def get_control(self, n: int) -> dict:
        keys = list(self.model.control)
        n_c = self.root_group["control"][keys[0]].shape[0]
        m = min(int(n), n_c - 1)
        return {k: self._row_cache(f"control/{k}").get(m) for k in keys}

    def get_prop(self) -> dict:
        g = self.root_group["properties"]
        return {k: g[k][()] for k in self.model.prop}

    def get_time(self, n: int) -> float:
        return float(self.root_group["time"][n])

    def get_times(self) -> np.ndarray:
        return self.root_group["time"][:]

    def get_meas_indices(self) -> np.ndarray:
        return self.root_group["meas_indices"][:]

    def get_solver_info(self, n: int) -> dict:
        g = self.root_group["solver_info"]
        return {k: g[k][n] for k in INFO_KEYS}

    def get_state_trajectory(self) -> dict:
        g = self.root_group["state"]
        return {k: g[k][:] for k in g}

    def get_control_trajectory(self) -> dict:
        g = self.root_group["control"]
        return {k: g[k][:] for k in g}
