"""
The Newmark predictor that K5 writes with each state
(``SolidModel._finish``) and that the next step takes in place of forming
it (``SolidModel._predictor``), on the CPU (where ``ops.newmark_update``
runs its plain version, which writes the same three outputs): the carry is
taken only for the very state K5 wrote, unmodified, and the step it was
formed for, so trajectories are bit-identical with and without it.
"""

import numpy as np
import pytest
import torch

from vf_fem_tpu import forward as jforward
from vf_fem_tpu_torch import forward as tforward
from vf_fem_tpu_torch.convert import to_numpy, to_tensors

from port_fixtures import (
    HEADLINE_SMALL,
    jax_inputs,
    jax_vf_model,
    port_inputs,
    port_vf_model,
)

# dt of each step varies by up to 50% about 1e-4: no two steps alike
_RNG = np.random.default_rng(17)
NONUNIFORM = 1e-4 * np.concatenate([[0.0], np.cumsum(_RNG.uniform(0.5, 1.5, 13))])
UNIFORM = 1e-4 * np.arange(14)


def _cloning(model):
    """Wrap ``model``'s step, factorize and refresh entry points so that
    each gets fresh copies of the state's tensors: the carry never hits."""
    def fresh(state):
        return {k: v.clone() for k, v in state.items()}

    for name, pos in (("step_pure", 0), ("step_pure_stale", 1),
                      ("factorize", 0), ("refresh_factors", 1)):
        orig = getattr(model, name)

        def wrapped(*args, _orig=orig, _pos=pos, **kw):
            args = list(args)
            args[_pos] = fresh(args[_pos])
            return _orig(*args, **kw)

        setattr(model, name, wrapped)
    return model


def _run(times, cloned=False):
    model = port_vf_model("KelvinVoigtWEpithelium")
    if cloned:
        _cloning(model)
    s0, cs, prop = port_inputs(model)
    fin, traj, infos = tforward.integrate_pure(model, s0, cs, prop, times,
                                               HEADLINE_SMALL)
    return model, traj, infos


@pytest.mark.parametrize("times", [UNIFORM, NONUNIFORM],
                         ids=["uniform", "nonuniform"])
def test_carry_is_bit_identical_to_forming_the_predictor(times):
    """13 steps of the headline settings (refresh windows of 5, Newton-
    Schulz refreshes): with the carry every step and every refresh after
    the first takes K5's predictor; cloned step inputs never do; the
    trajectories are equal bit for bit."""
    model, traj, infos = _run(times)
    cmodel, ctraj, cinfos = _run(times, cloned=True)
    n_steps = len(times) - 1
    # one predictor a step and one a refresh window (steps 0, 5, 10); all
    # but the first step's and the first window's come from the carry
    assert model.solid.predictor_counts == {"carried": n_steps - 1 + 2, "formed": 2}
    assert cmodel.solid.predictor_counts == {"carried": 0, "formed": n_steps + 3}
    for k in traj:
        assert torch.equal(traj[k], ctraj[k]), k
    assert torch.equal(infos.num_iter, cinfos.num_iter)


def test_nonuniform_times_match_jax_integrate_pure():
    """With a different dt every step the port (carrying the predictor
    of each next dt) follows the JAX package's ``integrate_pure``."""
    jmodel = jax_vf_model("KelvinVoigtWEpithelium")
    js0, jcs, jprop = jax_inputs(jmodel)
    jfin, jtraj, jinfos = jforward.integrate_pure(
        jmodel, js0, jcs, jprop, NONUNIFORM, {**HEADLINE_SMALL, "assembly": "plain"}
    )
    model, traj, infos = _run(NONUNIFORM)
    assert model.solid.predictor_counts["carried"] > 0
    traj = to_numpy(traj)
    # factors formed at a window's first dt leave each later step a chord
    # residual, through which the two packages' rounding of the explicit
    # inverse reaches the trajectory: max|diff| / max|ref| is 4.8e-13 in u,
    # 1.0e-11 in v, 4.1e-11 in a on an x86-64 CPU (the carry run and a run
    # that forms every predictor alike; 1e-15 to 1e-13 with uniform steps)
    for k in ("u", "v", "a", "q", "p"):
        ref = np.asarray(jtraj[k])
        np.testing.assert_allclose(traj[k], ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)
    np.testing.assert_array_equal(infos.num_iter.numpy(), np.asarray(jinfos.num_iter))


def _two_steps(edit):
    """A step, ``edit`` of its state (returns the state the second step
    gets), and the second step; returns (the second step's state, the
    predictor counts of the second step)."""
    model = port_vf_model("KelvinVoigtWEpithelium")
    s0, cs, prop = port_inputs(model)
    dev, dtype = model.device, model.dtype
    prop = to_tensors(prop, dev, dtype)
    control = {k: torch.as_tensor(v[0], dtype=dtype) for k, v in cs.items()}
    state = to_tensors(s0, dev, dtype)
    params = {"fixed_iterations": 2}
    state, _ = model.step_pure(state, control, prop, 1e-4, params, 1e-4)
    state["v"] = state["v"] + 1e-3  # a moving state, so that v and a matter
    state, _ = model.step_pure(state, control, prop, 1e-4, params, 1e-4)
    state2 = edit(state)
    model.solid.predictor_counts.update(carried=0, formed=0)
    out, _ = model.step_pure(state2, control, prop, 1e-4, params)
    counts = dict(model.solid.predictor_counts)
    # the same step from copies of the edited state: the predictor formed
    model.solid._carry = None
    ref, _ = model.step_pure({k: v.clone() for k, v in state2.items()},
                             control, prop, 1e-4, params)
    for k in out:
        assert torch.equal(out[k], ref[k]), k
    return counts


def test_carry_taken_for_the_state_as_written():
    assert _two_steps(lambda s: s) == {"carried": 1, "formed": 0}


@pytest.mark.parametrize("field", ["u", "v", "a"])
def test_carry_not_taken_after_an_in_place_edit(field):
    def edit(state):
        state[field].mul_(1.5)
        return state

    assert _two_steps(edit) == {"carried": 0, "formed": 1}


@pytest.mark.parametrize("field", ["u", "v", "a"])
def test_carry_not_taken_for_a_replaced_field(field):
    def edit(state):
        return {**state, field: state[field].clone()}

    assert _two_steps(edit) == {"carried": 0, "formed": 1}


def test_carry_not_taken_for_another_dt():
    """The carried predictor is of the step it was formed for."""
    model = port_vf_model("KelvinVoigtWEpithelium")
    s0, cs, prop = port_inputs(model)
    dev, dtype = model.device, model.dtype
    prop = to_tensors(prop, dev, dtype)
    control = {k: torch.as_tensor(v[0], dtype=dtype) for k, v in cs.items()}
    state = to_tensors(s0, dev, dtype)
    params = {"fixed_iterations": 1}
    state, _ = model.step_pure(state, control, prop, 1e-4, params, 2e-4)
    sl = {k: state[k] for k in ("u", "v", "a")}
    model.solid.predictor_counts.update(carried=0, formed=0)
    assert torch.equal(model.solid._predictor(sl, 2e-4), model.solid._carry[3])
    model.solid._predictor(sl, 1e-4)
    assert model.solid.predictor_counts == {"carried": 1, "formed": 1}


def test_newmark_bound_counts_seven_vectors():
    """K5's bound in ``chip_smoke.py``: four vectors and the row of eight
    coefficients in, three vectors out."""
    import chip_smoke

    n = 23_754
    for itemsize, acc in ((8, "float64"), (4, "float32")):
        nbytes, flops = chip_smoke.newmark_work(n, itemsize)
        assert nbytes == (7 * n + 8) * itemsize
        bound, by = chip_smoke.bound_of(nbytes, flops, acc)
        assert by == "bytes"
    assert chip_smoke.newmark_work(n, 8)[0] == 1_330_288
    assert round(chip_smoke.bound_of(*chip_smoke.newmark_work(n, 8), "float64")[0], 6) \
        == 0.000397
