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


def array_to_tensor(a, device) -> torch.Tensor:
    """An array as a tensor of its own dtype on ``device``, including
    numpy's ``bfloat16`` extension type (ml_dtypes, as JAX hands out bf16
    arrays), which ``torch.as_tensor`` does not take: its bits are carried
    over as int16.  The data is copied (JAX's arrays are read-only)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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


def from_blocks(bvec) -> dict:
    """A block vector (the JAX package's ``BlockVector``: a transform's
    ``x`` or ``y``, a model's ``prop``) as {label: numpy array}, in its
    block order: the port's form of the same vector."""
    return {k: np.array(v) for k, v in bvec.sub_items()}


def as_dict(vec) -> dict:
    """A vector as ``{label: array or tensor}``: a dict as it is, anything
    with ``sub_items()`` (the JAX package's BlockVector) by
    :func:`from_blocks`."""
    return from_blocks(vec) if hasattr(vec, "sub_items") else vec


def to_blocks(d: dict, like):
    """The port's vector ``d`` ({label: array or tensor}) as a copy of the
    block vector ``like`` with each of its blocks taken from ``d``: the
    way back to the JAX package's form."""
    out = like.copy()
    for k, v in to_numpy(d).items():
        out[k] = v
    return out
