"""
The fixed-iteration time step as one captured CUDA graph: the port's
counterpart of the JAX package's jitted ``lax.scan`` and its
``_scan_cache`` (``vf_fem_tpu/forward.py:39-279``).

A fixed-iteration chord step with factors carried through a refresh
window (``fixed_iterations`` set, ``jacobian_refresh_steps > 1``, a direct
solver: 'dense', 'btd' or 'spike') makes no host synchronisation, so one step is
captured once and replayed for every step of the run.  What the step reads
and writes lives in static buffers of a cache entry (:class:`StepBuffers`),
one per solver configuration (params), kept on the model, whatever the
number of steps:

- the state (``u, v, a, q, p``, and the FSAI model's tract ``pinc, pref``)
  and the Newmark predictor of the next step
  (the one K5 writes with the state, ``SolidModel.carry_predictor``);
- the rows of a chunk of ``CHUNK`` steps: held-last controls, Newmark
  coefficients (``equations.newmark.coefficients`` of each step's dt and
  the next step's in float64, rounded to the model's dtype: K5's rows,
  ``ops.newmark_row``), and the trajectory and solver infos the steps
  write (every field of the model's info type: the FSAI model's adds
  ``bracketed``), rows selected by a step counter on the device that the
  step increments;
- copies of the run's properties, and the factors.

The step writes its new state back into the state buffers (copy back, not
two graphs in turn).  Between chunks the host copies the next chunk's
rows in from the run's tables and the written rows out to the run's
trajectory, which the caller gets; so a run holds its trajectory once,
and the cache only a chunk of it.  Between windows the factorization or
Newton-Schulz refresh runs eagerly, as in the eager loop, and is copied
into the factor buffers (one copy of the factors a window, against a
capture of the step).  The first step of a run whose graph is not cached
yet runs uncaptured on the capture stream (warm-up), then the step is
captured, unless the run has no step left to replay it; a capture that
fails raises.  Replaying a step adds the launch and predictor counts that
the captured step made (``ops.LAUNCHES``, ``fem.banded.LAUNCHES``, the
solid's ``predictor_counts`` and ``krylov_counts``), which count Python
calls.

A batch of variants (``forward.integrate_batch_pure``) is one graph of
the batched step (the model's ``step_batch_stale``): every buffer holds
the batch (state, predictor, properties and factors (B, ...); controls,
trajectory and info rows (CHUNK, B, ...)), cached under the params and
the batch's size.

On the CPU :func:`integrate` runs the same step on the same buffers
uncaptured: ``tests/test_torch_integrate.py`` holds it to the eager loop
bit for bit, ``tests/test_torch_sweep.py`` the batched step to the batched
eager loop.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

import numpy as np
import torch

from . import ops
from .convert import to_tensors
from .equations import newmark
from .equations.newmark import coefficient_table  # noqa: F401 (the run's rows)
from .fem import banded
from .models.transient import ImplicitFSIModel, StepCoefs
from .solvers.newton import SolveInfo

# steps whose rows the buffers hold between two copies by the host
CHUNK = 16
# linear solvers whose carried factors a step solves with, on the device,
# without reading anything on the host
GRAPH_SOLVERS = ("dense", "btd", "spike")


def captures(model, params_d: dict) -> bool:
    """Whether :func:`~vf_fem_tpu_torch.forward.integrate_pure` runs
    ``params_d`` (merged solver parameters) as a replayed CUDA graph: a
    fixed-iteration run on a CUDA model whose steps solve with factors
    carried through refresh windows of more than one step, by a direct
    solver.  Every other run is eager by its configuration, and so is every
    run of an implicitly coupled model, whose Picard stop reads each
    iteration's residual norm on the host, and of a model without a solid
    (the WRA tract alone)."""
    return bool(
        not isinstance(model, ImplicitFSIModel)
        and getattr(model, "solid", None) is not None
        and params_d.get("fixed_iterations")
        and model.device.type == "cuda"
        and int(params_d.get("jacobian_refresh_steps", 1)) > 1
        and params_d.get("linear_solver", "dense") in GRAPH_SOLVERS
    )


def refresh_windows(n_steps: int, params_d: dict):
    """``(n0, n1, how)`` of each refresh window of a stale-factor run: how
    its factors are made at step n0, 'factor' (full factorization) or
    'refresh' (Newton-Schulz).  ``jacobian_refresh_mode='ns'`` factors in
    window 0 and every ``jacobian_full_refresh_windows``-th window and
    refreshes in the others, the trailing partial window by the same rule;
    'full' mode factors in every window."""
    refresh_k = int(params_d.get("jacobian_refresh_steps", 1))
    use_ns = params_d.get("jacobian_refresh_mode", "full") == "ns"
    full_every = int(params_d.get("jacobian_full_refresh_windows", 8))
    n_win, rem = divmod(n_steps, refresh_k)
    for w in range(n_win):
        how = "factor" if not use_ns or w % full_every == 0 else "refresh"
        yield w * refresh_k, (w + 1) * refresh_k, how
    if rem:
        how = "refresh" if use_ns and n_win and n_win % full_every else "factor"
        yield n_win * refresh_k, n_steps, how


def _counters(model):
    """The launch and iteration counts a replay adds to (dicts of ints)."""
    solid = model.solid
    return (ops.LAUNCHES, banded.LAUNCHES, solid.predictor_counts,
            solid.krylov_counts)


def _graph_nodes(graph) -> int:
    """Nodes of a captured (not yet instantiated) graph, by
    ``cuGraphGetNodes`` of libcuda."""
    lib = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(int(graph.raw_cuda_graph())), None,
                              ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(count.value)


def _pool_bytes(graph) -> Optional[int]:
    """Bytes of the segments of the graph's private memory pool (None where
    the allocator's snapshot does not name pools)."""
    pool = tuple(graph.pool())
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == pool)


# dtypes of the info fields that are not in the model's dtype
_INFO_DTYPES = {"num_iter": torch.int64, "bracketed": torch.bool}


def _infos(model, n):
    """Zeroed rows (``n``, an int or a shape) of each field of the model's
    step info (``info_type``, ``SolveInfo`` by default)."""
    info_type = getattr(model, "info_type", SolveInfo)
    return info_type(*(torch.zeros(n, dtype=_INFO_DTYPES.get(f, model.dtype),
                                   device=model.device) for f in info_type._fields))


class StepBuffers:
    """Static buffers of one captured step (see the module docstring) and,
    once captured, its graph with what the capture measured (``stats``);
    ``batch``, ``(B, batch_controls)``, of a batched step."""

    def __init__(self, model, params_d: dict, batch=None):
        dev, dtype = model.device, model.dtype
        self.model, self.params_d, self.batch = model, params_d, batch
        lead = () if batch is None else (batch[0],)
        self.state = {k: torch.zeros(lead + np.asarray(v).shape, dtype=dtype, device=dev)
                      for k, v in model.state0.items()}
        self.pred = torch.zeros_like(self.state["u"])
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.controls = {k: torch.zeros((CHUNK,) + lead + np.asarray(v).shape, dtype=dtype,
                                        device=dev)
                         for k, v in model.control.items()}
        self.coefs = torch.zeros((CHUNK, newmark.NCOEFS), dtype=dtype, device=dev)
        self.prop = None
        self.factors = None
        self.traj = {k: torch.zeros((CHUNK,) + tuple(v.shape), dtype=dtype, device=dev)
                     for k, v in self.state.items()}
        self.infos = _infos(model, (CHUNK,) + lead)
        self.graph = None
        self.delta = None
        self.stats = {"captures": 0, "replays": 0}

    # -- inputs and outputs ----------------------------------------------------
    def load(self, ini_state, prop):
        """Copy a run's initial state and properties into the buffers (the
        first run's properties are copied into new ones: the caller's
        tensors are never the graph's)."""
        dev, dtype = self.model.device, self.model.dtype
        for k, v in to_tensors(ini_state, dev, dtype).items():
            t = self.state[k]  # every variant starts from ini_state
            t.copy_(v.reshape(t.shape[self.batch is not None:]).expand(t.shape))
        prop = to_tensors(prop, dev, dtype)
        if self.prop is None:
            self.prop = {k: v.clone() for k, v in prop.items()}
        else:
            for k, t in self.prop.items():
                t.copy_(prop[k])

    def begin_chunk(self, run, n0: int, m: int):
        """Rows n0 .. n0 + m - 1 of the run's controls and coefficients
        into the chunk's, and the counter to 0."""
        for k, t in self.controls.items():
            t[:m].copy_(run.controls[k][n0:n0 + m])
        self.coefs[:m].copy_(run.coefs[n0:n0 + m])
        self.counter.zero_()

    def end_chunk(self, run, n0: int, m: int):
        """The chunk's m written rows out to rows n0 .. n0 + m - 1 of the
        run's trajectory and infos."""
        for k, t in self.traj.items():
            run.traj[k][n0:n0 + m].copy_(t[:m])
        for out, t in zip(run.infos, self.infos):
            out[n0:n0 + m].copy_(t[:m])

    def solid_state(self):
        return tuple(self.state[k] for k in ("u", "v", "a"))

    def form_predictor(self, dt: float):
        """The first step's predictor, formed eagerly into its buffer."""
        self.pred.copy_(self.model.solid._predictor(dict(zip("uva", self.solid_state())), dt))

    def set_factors(self, factors):
        """Factors made between windows: the first ones become the
        buffers, later ones are copied into them."""
        if self.factors is None:
            self.factors = factors
        else:
            for s, t in zip(self.factors, factors):
                s.copy_(t)

    # -- the step -------------------------------------------------------------
    def step(self):
        """One step from the buffers to the buffers; reads its rows at the
        device counter and increments it.  Makes no host synchronisation
        (captured as it is)."""
        model = self.model
        n = self.counter
        coefs = StepCoefs(self.coefs.index_select(0, n)[0], model.dtype)
        control = {k: t.index_select(0, n)[0] for k, t in self.controls.items()}
        model.solid.carry_predictor(self.solid_state(), self.pred, coefs)
        step = model.step_pure_stale if self.batch is None else model.step_batch_stale
        state1, info = step(self.factors, self.state, control, self.prop, coefs,
                            self.params_d)
        u_next = model.solid.carried_predictor()
        for k, t in self.traj.items():
            t.index_copy_(0, n, state1[k].unsqueeze(0))
        for t, x in zip(self.infos, info):
            t.index_copy_(0, n, x.unsqueeze(0))
        for k, t in self.state.items():
            t.copy_(state1[k])
        self.pred.copy_(u_next)
        n.add_(1)

    def capture(self):
        """Warm up (one real step, uncaptured, on the capture stream), then
        capture one step; records the counts the captured step made, the
        graph's nodes, the capture and instantiate times and its pool."""
        dev = self.model.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        counters = _counters(self.model)
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=side):
            self.step()
        t1 = time.perf_counter()
        # the captured calls launched nothing: the replays count them
        self.delta = [{k: c[k] - b.get(k, 0) for k in c} for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.update(b)
        nodes = _graph_nodes(graph)
        t2 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        self.graph = graph
        self.stats.update(captures=self.stats["captures"] + 1, nodes=nodes,
                          capture_ms=(t1 - t0) * 1e3, instantiate_ms=(t3 - t2) * 1e3,
                          pool_bytes=_pool_bytes(graph))

    def replay(self):
        self.graph.replay()
        for c, d in zip(_counters(self.model), self.delta):
            for k, v in d.items():
                c[k] += v
        self.stats["replays"] += 1


def params_key(params_d: dict) -> tuple:
    return tuple(sorted(params_d.items(), key=lambda kv: kv[0]))


def cache_key(params_d: dict, batch=None) -> tuple:
    """The key of a run's step graph in ``model._step_graphs``: its merged
    solver parameters, and a batched run's ``(B, batch_controls)``."""
    key = params_key(params_d)
    return key if batch is None else key + (("batch", batch),)


def graph_stats(model) -> dict:
    """``{params key: stats}`` of the model's cached step graphs: captures,
    replays, nodes, capture_ms, instantiate_ms, pool_bytes."""
    return {key: dict(b.stats) for key, b in getattr(model, "_step_graphs", {}).items()}


class _Run:
    """One run's tables on the device: its held-last controls and Newmark
    coefficients, a row a step, and the trajectory and infos its steps
    write, which the caller gets."""

    def __init__(self, model, controls, dts, batch=None):
        dev, dtype = model.device, model.dtype
        n_steps = len(dts)
        lead = () if batch is None else (batch[0],)
        n_controls = next(iter(controls.values())).shape[0]
        held = torch.as_tensor(np.minimum(np.arange(n_steps), n_controls - 1), device=dev)
        self.controls = {k: controls[k].index_select(0, held).reshape(
                             (n_steps,) + lead + np.asarray(v).shape)
                         for k, v in model.control.items()}
        self.coefs = ops.newmark_row(coefficient_table(dts), dtype, dev)
        self.traj = {k: torch.empty((n_steps,) + lead + np.asarray(v).shape, dtype=dtype,
                                    device=dev)
                     for k, v in model.state0.items()}
        self.infos = _infos(model, (n_steps,) + lead)

    def control_row(self, n: int) -> dict:
        return {k: t[n] for k, t in self.controls.items()}


def integrate(model, ini_state, controls_stacked, prop, times, params_d: dict,
              batch=None):
    """:func:`~vf_fem_tpu_torch.forward.integrate_pure` of a run that
    :func:`captures` selects: each step a replay of the cached graph (its
    first step, where the graph is new, a warm-up before the capture).  A
    CPU model runs the same step uncaptured on fresh buffers.  ``batch``,
    ``(B, batch_controls)``: the batched run of
    ``forward.integrate_batch_pure`` (trajectory and infos (n_steps, B,
    ...))."""
    from .forward import run_inputs, steppers

    dts = np.diff(np.asarray(times, dtype=np.float64))
    n_steps = len(dts)
    if n_steps < 1:
        raise ValueError("integrate_pure needs at least two time points")
    capture = model.device.type == "cuda"
    cache = model.__dict__.setdefault("_step_graphs", {})
    key = cache_key(params_d, batch)
    buf = cache.get(key) if capture else None
    if buf is None:
        buf = StepBuffers(model, params_d, batch)
    solid = model.solid
    _, _, factorize, refresh, _ = steppers(model, batch)
    with torch.no_grad():
        _, controls, prop = run_inputs(model, {}, controls_stacked, prop, batch)
        run = _Run(model, controls, dts, batch)
        buf.load(ini_state, prop)
        buf.form_predictor(float(dts[0]))
        for n0, n1, how in refresh_windows(n_steps, params_d):
            dt0 = float(dts[n0])
            # the window's factors at the carried predictor of step n0
            solid.carry_predictor(buf.solid_state(), buf.pred, dt0)
            if how == "factor":
                factors = factorize(buf.state, run.control_row(n0), buf.prop, dt0, params_d)
            else:
                factors = refresh(buf.factors, buf.state, run.control_row(n0), buf.prop, dt0,
                                  params_d)
            buf.set_factors(factors)
            for n in range(n0, n1):
                j = n % CHUNK
                if j == 0:
                    buf.begin_chunk(run, n, min(CHUNK, n_steps - n))
                if buf.graph is not None:
                    buf.replay()
                elif capture and n < n_steps - 1:  # a replay follows
                    buf.capture()
                    cache[key] = buf
                else:
                    buf.step()
                if j == CHUNK - 1 or n == n_steps - 1:
                    buf.end_chunk(run, n - j, j + 1)
    return {k: t.clone() for k, t in buf.state.items()}, run.traj, run.infos
