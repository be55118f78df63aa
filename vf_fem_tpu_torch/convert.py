"""
Conversion of ``prop``/``control``/``state`` dicts between numpy arrays and
tensors on a model's device -- how parameters built for (or by) the JAX
package are carried into the port and results carried back.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(v, device, dtype) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


def to_tensors(d: dict, device, dtype) -> dict:
    """{key: array-like} -> {key: tensor on ``device`` of ``dtype``}, keys
    in the same order."""
    return {k: _tensor(v, device, dtype) for k, v in d.items()}


def to_numpy(d: dict) -> dict:
    """{key: tensor or array} -> {key: numpy array}."""
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for k, v in d.items()
    }
