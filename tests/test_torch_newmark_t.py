"""
K5's backward against the JAX package on the CPU: the port's path is
``ops.newmark_step`` (K5 forward; its backward ``ops.newmark_update_t``
takes the plain version on CPU tensors) with its coefficient row from
``equations.newmark.coefficient_rows`` on a ``dts`` tensor that requires
grad, so the dt cotangent reaches ``dts`` through the row's cotangent and
the rows' closed forms.  The reference is ``jax.vjp`` of
``vf_fem_tpu.equations.newmark.newmark_v`` and ``newmark_a`` with respect
to (u1, u0, v0, a0, dt), under the same cotangents of v1 and a1.  Inputs
come from a numpy seed, in f64 and f32; the four vector cotangents are held
entry by entry to rtol 1e-13 (f64) / 1e-5 (f32), the dt cotangent to rtol
1e-12 / 1e-4 (it is a sum over the entries, taken in another order by
each package).

Besides, K5T's slots (``ops.kernels._newmark_t_slot``: the arrival counter
and partial sums a launch uses), which are bookkeeping on the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vjp

from vf_fem_tpu.equations import newmark as jnewmark
from vf_fem_tpu_torch import ops
from vf_fem_tpu_torch.equations import newmark

DT = 1e-4
# (vector cotangents, dt cotangent)
RTOL = {torch.float64: (1e-13, 1e-12), torch.float32: (1e-5, 1e-4)}


def _port_grads(host, cotangents, dtype):
    vecs = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in host]
    dts = torch.tensor([DT], dtype=torch.float64, requires_grad=True)
    row = newmark.coefficient_rows(dts)[0].to(dtype)
    v1, a1, _ = ops.newmark_step(*vecs, row)
    return torch.autograd.grad((v1, a1), (*vecs, dts),
                               tuple(torch.tensor(c, dtype=dtype) for c in cotangents))


def _jax_grads(host, cotangents, np_dtype):
    def relations(u1, u0, v0, a0, dt):
        return (jnewmark.newmark_v(u1, u0, v0, a0, dt),
                jnewmark.newmark_a(u1, u0, v0, a0, dt))

    args = [jnp.asarray(x, dtype=np_dtype) for x in host] + [jnp.asarray(DT, dtype=np_dtype)]
    _, pullback = vjp(relations, *args)
    return pullback(tuple(jnp.asarray(c, dtype=np_dtype) for c in cotangents))


@pytest.mark.parametrize("n", [1, 123, 960])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_newmark_backward_matches_jax_vjp(dtype, n):
    rng = np.random.default_rng(n)
    host = rng.standard_normal((4, n))  # u1, u0, v0, a0
    cotangents = rng.standard_normal((2, n))  # of v1, a1
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    mine = _port_grads(host, cotangents, dtype)
    ref = _jax_grads(host, cotangents, np_dtype)
    rtol_vec, rtol_dt = RTOL[dtype]
    for name, g, r in zip(("u1", "u0", "v0", "a0"), mine[:4], ref[:4]):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol_vec, atol=0, err_msg=name)
    assert mine[4].shape == (1,)
    np.testing.assert_allclose(mine[4].item(), float(ref[4]), rtol=rtol_dt, atol=0)


@pytest.fixture
def fresh_slots(monkeypatch):
    """K5T's slot table emptied, five slots a device."""
    from vf_fem_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "_T_SLOTS", {})
    monkeypatch.setattr(kernels, "NEWMARK_T_SLOTS", 5)
    return kernels._newmark_t_slot


def test_newmark_t_slot_per_stream_and_capture(fresh_slots):
    """A (device, stream, capture) keeps its slot; another stream, or
    another capture on one stream (two graphs captured one after the other
    on PyTorch's one capture stream), takes a slot of its own; each device
    numbers its own slots."""
    eager = fresh_slots(0, 11, 0)
    assert fresh_slots(0, 11, 0) == eager
    others = [fresh_slots(0, 12, 0), fresh_slots(0, 11, 7), fresh_slots(0, 11, 8),
              fresh_slots(0, 12, 7)]
    assert sorted([eager, *others]) == list(range(5))
    assert fresh_slots(0, 11, 8) == others[2]
    assert fresh_slots(1, 11, 0) == 0


def test_newmark_t_slots_run_out(fresh_slots):
    """A device out of slots raises; the keys that hold one keep it, and
    another device still has its own."""
    for stream in range(5):
        assert fresh_slots(0, stream, 0) == stream
    with pytest.raises(RuntimeError, match="more than 5 streams and graph captures on cuda:0"):
        fresh_slots(0, 5, 0)
    with pytest.raises(RuntimeError, match="more than 5"):
        fresh_slots(0, 0, 9)
    assert fresh_slots(0, 3, 0) == 3
    assert fresh_slots(1, 5, 0) == 0
