"""
Post-processing measures (counterpart of ``vf_fem_tpu.postprocess.base``).

``BaseStateMeasure`` maps a single ``(state, control, prop)`` instant to a
value; ``TimeSeries`` maps it over a stored run; ``TimeSeriesStats``
aggregates.  Gradients of P1 fields are constant per element, so the
reference's DG0 projections are exact pointwise evaluations here, with no
linear solve.

Measures implement ``assem_pure(state, control, prop)``: a function of the
state and control tensors on the model's device, batched by
``torch.func.vmap`` (no Python branch on a tensor's value); ``prop`` stays
a dict of host (numpy) constants, read as Python floats or moved to the
device by the measure.
``TimeSeries`` evaluates a whole stored run as one ``vmap`` over the
stacked states on the model's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from ..convert import as_dict, to_numpy, to_tensors


def _to_host(out):
    """A measure's value (a tensor or a dict of them) as numpy."""
    return to_numpy(out) if isinstance(out, dict) else out.detach().cpu().numpy()


class BaseStateMeasure:
    """Map an instant ``(state, control, prop)`` to a value."""

    def __init__(self, model, **kwargs):
        self.model = model
        self.kwargs = kwargs

    def __call__(self, state, control, prop):
        return self.assem(state, control, prop)

    def _device(self):
        return self.model.device, self.model.dtype

    def assem_pure(self, state, control, prop):
        """The measure of one instant: ``state``/``control`` are dicts of
        tensors on the model's device (batched under ``vmap``), ``prop``
        host numpy."""
        raise NotImplementedError

    def assem(self, state, control, prop):
        """The measure of one instant from host or device vectors, as numpy."""
        dev, dtype = self._device()
        state = to_tensors(as_dict(state), dev, dtype)
        control = to_tensors(as_dict(control), dev, dtype)
        with torch.no_grad():
            return _to_host(self.assem_pure(state, control, to_numpy(as_dict(prop))))


class BaseDerivedStateMeasure(BaseStateMeasure):
    """A measure derived from another instant measure ``func``: written in
    terms of ``func.assem_pure``, it batches under ``TimeSeries`` like a
    primitive one."""

    def __init__(self, func: BaseStateMeasure):
        super().__init__(func.model)
        self.func = func


class BaseStateHistoryMeasure:
    """A measure of a whole state history (a statefile)."""

    def __init__(self, model, **kwargs):
        self.model = model
        self.kwargs = kwargs

    def __call__(self, f, **kwargs):
        return self.assem(f, **kwargs)

    def assem(self, f, **kwargs):
        raise NotImplementedError


class BaseDerivedStateHistoryMeasure(BaseStateHistoryMeasure):
    """A history measure derived from an instant measure ``func``."""

    def __init__(self, func: BaseStateMeasure):
        super().__init__(func.model)
        self.func = func


class TimeSeries(BaseDerivedStateHistoryMeasure):
    """The measure at every stored state of ``f`` (anything with ``size``,
    ``get_state``, ``get_control`` and ``get_prop``, such as
    ``statefile.StateFile``), or at the rows ``ns``.

    A measure with ``assem_pure`` runs as one ``torch.func.vmap`` over the
    stacked states on the model's device; one without (that raises
    ``NotImplementedError``) takes the per-state loop of
    :meth:`assem_loop`."""

    def __call__(self, f, ns: Optional[range] = None):
        return self.assem(f, ns=ns)

    def _rows(self, f, ns):
        """The rows ``ns`` of ``f`` stacked on the model's device (rows of
        tensors are stacked where they lie, numpy rows on the host)."""
        dev, dtype = self.func._device()

        def stack(rows):
            return to_tensors({k: torch.stack([r[k] for r in rows])
                               if isinstance(rows[0][k], torch.Tensor)
                               else np.stack([np.asarray(r[k]) for r in rows])
                               for k in rows[0]}, dev, dtype)

        return (stack([as_dict(f.get_state(n)) for n in ns]),
                stack([as_dict(f.get_control(n)) for n in ns]),
                to_numpy(as_dict(f.get_prop())))

    def _batched(self, f, ns):
        """The series as one ``vmap`` of ``assem_pure``."""
        states, controls, prop = self._rows(f, ns)
        with torch.no_grad():
            out = vmap(lambda s, c: self.func.assem_pure(s, c, prop))(states, controls)
        return _to_host(out)

    def assem_loop(self, f, ns):
        """The series state by state (the measure's ``__call__``); a measure
        of dicts gives a dict of series, as the batched path does."""
        prop = f.get_prop()
        out = [self.func(f.get_state(n), f.get_control(n), prop) for n in ns]
        if isinstance(out[0], dict):
            return {k: np.array([np.asarray(o[k]) for o in out]) for k in out[0]}
        return np.array([np.asarray(o) for o in out])

    def assem(self, f, ns: Optional[range] = None):
        if ns is None:
            ns = range(f.size)
        if len(ns) == 0:
            return np.array([])
        try:
            return self._batched(f, ns)
        except NotImplementedError:
            return self.assem_loop(f, ns)


class TimeSeriesStats(BaseDerivedStateHistoryMeasure):
    """Statistics of a measure's time series."""

    def __init__(self, measure: BaseStateMeasure):
        super().__init__(measure)
        self.series = TimeSeries(measure)

    def assem(self, f, **kwargs):
        return self.mean(f, **kwargs)

    def std(self, f, **kwargs):
        return np.std(self.series(f, **kwargs), axis=0)

    def mean(self, f, **kwargs):
        return np.mean(self.series(f, **kwargs), axis=0)

    def min(self, f, **kwargs):
        return np.min(self.series(f, **kwargs), axis=0)

    def max(self, f, **kwargs):
        return np.max(self.series(f, **kwargs), axis=0)

    def total(self, f, **kwargs):
        return np.sum(self.series(f, **kwargs), axis=0)
