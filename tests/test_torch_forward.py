"""
The port's forward path end to end on the CPU in f64: the explicit-FSI
golden trajectory, and the headline solver settings against the JAX
package's ``integrate_pure`` on the same model.
"""

import os

import numpy as np
import pytest

from vf_fem_tpu import forward as jforward
from vf_fem_tpu_torch import forward as tforward
from vf_fem_tpu_torch.convert import to_numpy
from vf_fem_tpu_torch.fem import banded as tbanded

from port_fixtures import (
    HEADLINE_SMALL,
    jax_inputs,
    jax_vf_model,
    port_inputs,
    port_vf_model,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_fsi_explicit.npz")


@pytest.mark.parametrize("assembly", ["auto", "plain"])
def test_port_reproduces_explicit_golden(assembly):
    """Same tolerances as tests/test_golden.py; 'auto' takes the banded
    cell pass (its plain PyTorch versions on the CPU)."""
    data = np.load(GOLDEN)
    model = port_vf_model()
    state0, cs, prop = port_inputs(model)
    fin, traj, infos = tforward.integrate_pure(
        model, state0, cs, prop, data["times"], {"assembly": assembly}
    )
    assert model.solid.use_banded({"assembly": assembly}) == (
        assembly == "auto"
    )
    np.testing.assert_allclose(
        traj["u"].numpy()[::8], data["u"], rtol=1e-8, atol=1e-12
    )
    np.testing.assert_allclose(traj["q"].numpy().ravel(), data["q"], rtol=1e-8)
    np.testing.assert_allclose(
        traj["p"].numpy()[-1], data["p_final"], rtol=1e-8, atol=1e-8
    )


def test_headline_params_match_jax_integrate_pure():
    """28 steps with refresh windows of 5 and a full refactor every 2nd
    window: window 0 keeps the initial factors, odd windows refresh by
    Newton-Schulz, even ones refactor, and the 3-step remainder (after 5
    windows) refreshes.  The JAX side runs the plain assembly."""
    times = 1e-4 * np.arange(29)
    jmodel = jax_vf_model("KelvinVoigtWEpithelium")
    js0, jcs, jprop = jax_inputs(jmodel)
    jfin, jtraj, jinfos = jforward.integrate_pure(
        jmodel, js0, jcs, jprop, times, {**HEADLINE_SMALL, "assembly": "plain"}
    )

    tmodel = port_vf_model("KelvinVoigtWEpithelium")
    ts0, tcs, tprop = port_inputs(tmodel)
    assert list(tprop) == list(jprop)
    assert list(ts0) == list(js0) and list(tcs) == list(jcs)
    tbanded.LAUNCHES.update(gather=0, scatter=0)
    tfin, ttraj, tinfos = tforward.integrate_pure(
        tmodel, ts0, tcs, tprop, times, {**HEADLINE_SMALL, "assembly": "banded"}
    )
    # on the CPU the banded ops run their plain versions: no kernel launch
    assert tbanded.LAUNCHES == {"gather": 0, "scatter": 0}
    # the atol only covers entries at the rounding-noise level of the
    # Newton residual (~1e-18 absolute in u, where u itself is ~1e-20)
    ttraj = to_numpy(ttraj)
    for k in ("u", "v", "a", "q", "p"):
        ref = np.asarray(jtraj[k])
        np.testing.assert_allclose(
            ttraj[k], ref, rtol=1e-9,
            atol=1e-12 * np.abs(ref).max(), err_msg=k,
        )
    np.testing.assert_array_equal(
        tinfos.num_iter.numpy(), np.asarray(jinfos.num_iter)
    )
