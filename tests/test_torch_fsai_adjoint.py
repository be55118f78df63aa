"""
The FSAI gradient paths beside the dense one (``tests/test_torch_fsai_grad.py``),
on the CPU in f64, on the 8 x 4 model of ``tests/test_fsai.py`` (12 tubes):
value+grad of the RMS radiated pressure on block-Thomas solves (the large
meshes' path: K6 forward, the transposed sweep K6T in the IFT rule) equals
the dense one on an RCM-ordered copy of the model, and ``adjoint.integrate``
on a statefile gives ``integrate_grad``'s value and gradients.
"""

import numpy as np
import pytest

from vf_fem_tpu_torch import adjoint, forward
from vf_fem_tpu_torch.functional.acoustic import RmsRadiatedPressure

from port_fixtures import port_fsai_model, port_inputs
from test_fsai import make_fsai_model

N_STEPS = 16


@pytest.fixture(scope="module")
def models():
    jm = make_fsai_model(nx=8, ny=4)
    return jm, port_fsai_model(jm, nx=8, ny=4)


def test_btd_gradient_matches_dense(models):
    """The FSAI value+grad on block-Thomas solves (the large meshes' path:
    K6 forward, the transposed sweep K6T in the IFT rule, exact factors)
    equals the dense one on an RCM-ordered copy of the model, within 1e-9
    of each key's largest entry."""
    from vf_fem_tpu_torch.load import load_fsai_model
    from vf_fem_tpu_torch.mesh import vocal_fold_mesh
    from vf_fem_tpu_torch.residuals import fluid as flr, solid as slr

    jm, _ = models
    tm = load_fsai_model(vocal_fold_mesh(8, 4), slr.KelvinVoigt, flr.BernoulliSmoothMinSep,
                         num_tube=jm.acoustic.num_tube, reorder="rcm", device="cpu")
    for k in tm.prop:
        tm.prop[k][:] = np.asarray(jm.prop[k])
    tm.control["psub"][:] = np.asarray(jm.control["psub"])
    state0, _, prop = port_inputs(tm)
    times = tm.dt * np.arange(N_STEPS + 1)
    out = {}
    for solver, params in (("dense", {"jacobian_refresh_steps": 1}),
                           ("btd", {"linear_solver": "btd", "assembly": "banded",
                                    "jacobian_refresh_steps": 1, "adjoint_refine": "exact"})):
        out[solver] = adjoint.integrate_grad(tm, RmsRadiatedPressure(tm), state0,
                                             [tm.control], prop, times, params)
    (vd, gd), (vb, gb) = out["dense"], out["btd"]
    np.testing.assert_allclose(vb, vd, rtol=1e-12)
    for group in ("controls", "prop"):
        for k, ref in gd[group].items():
            scale = np.abs(ref).max()
            assert np.abs(gb[group][k] - ref).max() <= 1e-9 * scale, (group, k)
    assert np.abs(gd["prop"]["area"]).max() > 0


def test_adjoint_integrate_on_a_statefile(models, tmp_path):
    """``adjoint.integrate`` replays the run stored in a statefile and gives
    ``integrate_grad``'s value and gradients (the file holds a control row
    at each time: their gradients sum to the held control's)."""
    from vf_fem_tpu_torch import statefile as sf

    _, tm = models
    state0, _, prop = port_inputs(tm)
    times = tm.dt * np.arange(N_STEPS + 1)
    port_grad = adjoint.integrate_grad(tm, RmsRadiatedPressure(tm), state0, [tm.control],
                                       prop, times)
    with sf.StateFile(tm, str(tmp_path / "fsai.h5"), mode="w") as f:
        forward.integrate(tm, f, state0, [tm.control], prop, times)
        value, grads = adjoint.integrate(tm, f, RmsRadiatedPressure(tm))
    assert value == port_grad[0]
    for group in ("prop", "ini_state"):
        for k, g in port_grad[1][group].items():
            np.testing.assert_array_equal(grads[group][k], g)
    np.testing.assert_allclose(grads["controls"]["psub"].sum(),
                               port_grad[1]["controls"]["psub"].sum(), rtol=1e-12)
