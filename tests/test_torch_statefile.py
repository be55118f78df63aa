"""
The port's HDF5 statefile (``vf_fem_tpu_torch.statefile``) against the JAX
package's (``vf_fem_tpu.statefile``): one schema, so that a file written by
either package reads in the other, on the small explicit-FSI model.
"""

import h5py
import numpy as np
import pytest

from vf_fem_tpu import statefile as jsf
from vf_fem_tpu.blocks import BlockVector
from vf_fem_tpu_torch import statefile as tsf

from port_fixtures import jax_vf_model, port_vf_model

N_ROWS = 7


@pytest.fixture(scope="module")
def models():
    return jax_vf_model(), port_vf_model()


def _rows(tmodel, seed=0):
    """Random state, control and info rows, as numpy dicts."""
    rng = np.random.default_rng(seed)
    states = [{k: rng.standard_normal(np.asarray(v).size) for k, v in tmodel.state0.items()}
              for _ in range(N_ROWS)]
    controls = [{k: rng.standard_normal(np.asarray(v).size) for k, v in tmodel.control.items()}
                for _ in range(N_ROWS)]
    infos = [{"num_iter": int(rng.integers(1, 5)), "abs_err": float(rng.random()),
              "rel_err": float(rng.random())} for _ in range(N_ROWS)]
    return states, controls, infos


def _bv(d):
    keys = list(d)
    return BlockVector([np.asarray(d[k]) for k in keys], labels=[keys])


def _write(sf_module, model, path, rows, prop, to_row=lambda d: d, ns=(0, 3),
           nchunk=None):
    states, controls, infos = rows
    kw = {} if nchunk is None else {"NCHUNK": nchunk}
    with sf_module.StateFile(model, path, mode="w", **kw) as f:
        f.init_layout()
        for n, (s, c, i) in enumerate(zip(states, controls, infos)):
            f.append_state(to_row(s))
            f.append_control(to_row(c))
            f.append_time(0.25 * n)
            f.append_solver_info(i)
        f.append_prop(to_row(prop))
        for n in ns:
            f.append_meas_index(n)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_read_in_the_other_package(models, tmp_path, writer):
    """Rows written by one package read back equal in the other: states,
    controls (held past the last row), times, infos, props, meas indices."""
    jm, tm = models
    rows = _rows(tm)
    path = str(tmp_path / "run.h5")
    if writer == "port":
        _write(tsf, tm, path, rows, tm.prop)
        reader, model, conv = jsf, jm, lambda bv: {k: np.asarray(v) for k, v in bv.sub_items()}
    else:
        _write(jsf, jm, path, rows, tm.prop, to_row=_bv)
        reader, model, conv = tsf, tm, dict
    states, controls, infos = rows
    with reader.StateFile(model, path) as f:
        assert f.size == N_ROWS
        for n in (0, 4, N_ROWS - 1, -1):
            got = conv(f.get_state(n))
            assert list(got) == list(states[n])
            for k in got:
                np.testing.assert_array_equal(got[k], states[n][k])
        for n in (2, N_ROWS + 3):
            got = conv(f.get_control(n))
            for k in got:
                np.testing.assert_array_equal(got[k], controls[min(n, N_ROWS - 1)][k])
        np.testing.assert_array_equal(f.get_times(), 0.25 * np.arange(N_ROWS))
        assert f.get_time(3) == 0.75
        for k, v in f.get_solver_info(5).items():
            assert v == infos[5][k]
        prop = conv(f.get_prop())
        for k, v in tm.prop.items():
            np.testing.assert_array_equal(prop[k], v)
        np.testing.assert_array_equal(f.get_meas_indices(), [0, 3])


def _datasets(path):
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj.shape, obj.maxshape, obj.chunks, obj.dtype, obj[()])

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def test_schema_is_the_jax_packages(models, tmp_path):
    """The same rows written by both packages give the same datasets:
    names, shapes, maxshape, chunks, dtypes and values (mesh and dofmap
    groups included)."""
    jm, tm = models
    rows = _rows(tm, seed=1)
    _write(tsf, tm, str(tmp_path / "port.h5"), rows, tm.prop)
    _write(jsf, jm, str(tmp_path / "jax.h5"), rows, tm.prop, to_row=_bv)
    port, jax = _datasets(str(tmp_path / "port.h5")), _datasets(str(tmp_path / "jax.h5"))
    assert sorted(port) == sorted(jax)
    assert {"mesh/solid/coordinates", "dofmap/vector", "state/u", "control/psub",
            "solver_info/rel_err", "time", "meas_indices"} <= set(port)
    for name, (shape, maxshape, chunks, dtype, value) in jax.items():
        p = port[name]
        assert p[:4] == (shape, maxshape, chunks, dtype), name
        np.testing.assert_array_equal(p[4], value, err_msg=name)


def test_append_window_equals_row_appends(models, tmp_path):
    """One window of T rows writes what T row-by-row appends write."""
    _, tm = models
    states, controls, infos = _rows(tm, seed=2)
    _write(tsf, tm, str(tmp_path / "rows.h5"), (states, controls, infos), tm.prop, ns=())
    with tsf.StateFile(tm, str(tmp_path / "window.h5"), mode="w") as f:
        f.init_layout()
        f.append_window(
            {k: np.stack([s[k] for s in states]) for k in states[0]},
            {k: np.stack([c[k] for c in controls]) for k in controls[0]},
            0.25 * np.arange(N_ROWS),
            {k: np.array([i[k] for i in infos]) for k in infos[0]},
        )
        f.append_prop(tm.prop)
    rows, window = _datasets(str(tmp_path / "rows.h5")), _datasets(str(tmp_path / "window.h5"))
    assert sorted(rows) == sorted(window)
    for name, (shape, maxshape, chunks, dtype, value) in rows.items():
        assert window[name][:4] == (shape, maxshape, chunks, dtype), name
        np.testing.assert_array_equal(window[name][4], value, err_msg=name)


def test_reverse_reads_go_through_the_chunk_cache(models, tmp_path):
    """Rows read in reverse order (as an adjoint sweep reads them) load
    each chunk of rows once: 7 rows in chunks of 3 are 3 chunk reads."""
    _, tm = models
    rows = _rows(tm, seed=3)
    path = str(tmp_path / "chunks.h5")
    _write(tsf, tm, path, rows, tm.prop, nchunk=3)
    with tsf.StateFile(tm, path) as f:
        for n in reversed(range(N_ROWS)):
            np.testing.assert_array_equal(f.get_state(n)["u"], rows[0][n]["u"])
        cache = f._caches["state/u"]
        assert cache.chunk_rows == 3 and cache.reads == 3
        for n in (0, 2, 1, 4):  # rows of the two chunks held: no read
            np.testing.assert_array_equal(f.get_state(n)["u"], rows[0][n]["u"])
        assert cache.reads == 3
