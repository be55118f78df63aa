"""
The port's entry points build on the card unless the caller asks for the
CPU: the default ``device`` of the model factory and of every residual
constructor is CUDA, and without a CUDA device they raise rather than
build on the CPU.  Whether this process has a card is decided inside the
tests, never at import.
"""

import inspect

import pytest
import torch

from vf_fem_tpu_torch import config
from vf_fem_tpu_torch.load import load_fluid_model, load_fsi_model, load_solid_model
from vf_fem_tpu_torch.mesh import vocal_fold_mesh
from vf_fem_tpu_torch.residuals import base, fluid as flr, solid as slr

ENTRY_POINTS = {
    "load_fsi_model": load_fsi_model,
    "load_solid_model": load_solid_model,
    "load_fluid_model": load_fluid_model,
    "FemResidual": base.FemResidual.__init__,
    "PredefinedSolidResidual": slr.PredefinedSolidResidual.__init__,
    "PredefinedFluidResidual": flr.PredefinedFluidResidual.__init__,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_is_cuda(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"].default
    assert torch.device(default).type == "cuda"


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")


def test_fsi_model_without_card_raises():
    _needs_no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_fsi_model(vocal_fold_mesh(4, 2), slr.KelvinVoigt,
                       flr.BernoulliAreaRatioSep)


@pytest.mark.parametrize("Residual", [slr.KelvinVoigt, slr.KelvinVoigtWEpithelium])
def test_solid_residual_without_card_raises(Residual):
    _needs_no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Residual(vocal_fold_mesh(4, 2))


def test_fluid_residual_without_card_raises():
    _needs_no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flr.BernoulliAreaRatioSep(torch.linspace(0, 1, 5).numpy())


def test_cpu_on_request():
    """``device='cpu'`` builds on the CPU with or without a card."""
    model = load_fsi_model(vocal_fold_mesh(4, 2), slr.KelvinVoigt,
                           flr.BernoulliAreaRatioSep, device="cpu")
    assert model.solid.residual.device == torch.device("cpu")
    assert config.model_device("cpu") == torch.device("cpu")
