"""Hand-written CUDA kernels of the Krylov path (K3, K4, K5) with their
plain PyTorch versions; see :mod:`.kernels`."""

from .kernels import (  # noqa: F401
    LAUNCHES,
    bsb_matvec,
    bsb_matvec_reference,
    dot_order_bound,
    ebe_matvec,
    ebe_matvec_reference,
    newmark_update,
    newmark_update_reference,
)
