"""Per-step residual diagnostics (counterpart of
``vf_fem_tpu.stepfunctional``)."""

from .base import make_residuals  # noqa: F401
