"""
Signal utilities for phonation analysis (a copy of
``vf_fem_tpu.misc.signal``: numpy only, which the port does not import).

The reference's e2e tests use the external ``vfsig`` package to extract the
fundamental frequency and amplitude of the glottal-width signal
(reference: ``tests/test_forward.py:235-257``); this provides the
equivalent in-repo.
"""

from __future__ import annotations

import numpy as np


def fundamental_mode_from_rfft(y: np.ndarray, dt: float):
    """
    Return (f0, amplitude) of the dominant non-DC mode of ``y``.

    Mirrors ``vfsig.modal.fundamental_mode_from_rfft`` usage: amplitude is
    the (one-sided) spectral amplitude of the dominant bin.
    """
    y = np.asarray(y, dtype=float)
    n = y.size
    yf = np.fft.rfft(y - y.mean())
    freqs = np.fft.rfftfreq(n, d=dt)
    k = int(np.argmax(np.abs(yf[1:]))) + 1
    amplitude = 2 * np.abs(yf[k]) / n
    return float(freqs[k]), float(amplitude)


def is_oscillating(y: np.ndarray, rel_threshold: float = 0.01) -> bool:
    """Heuristic: does the signal sustain oscillation (not decay to
    steady state)?  Compares late-window to early-window variance."""
    y = np.asarray(y, dtype=float)
    n = y.size
    early = y[n // 4 : n // 2]
    late = y[3 * n // 4 :]
    return late.std() > rel_threshold * max(early.std(), 1e-30)
