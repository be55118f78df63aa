"""Hand-written CUDA kernels of the solvers (K3, K4, K5, K6) and of their
backward (K5T, K6T) with their plain PyTorch versions; see
:mod:`.kernels`."""

from .kernels import (  # noqa: F401
    LAUNCHES,
    bsb_matvec,
    bsb_matvec_reference,
    btd_sweep,
    btd_sweep_reference,
    btd_sweep_rows_reference,
    btd_sweep_t,
    btd_sweep_t_reference,
    btd_sweep_t_rows_reference,
    dot_order_bound,
    ebe_matvec,
    ebe_matvec_reference,
    factor_matvec,
    newmark_update,
    newmark_update_coefs,
    newmark_update_coefs_reference,
    newmark_update_reference,
    newmark_row,
    newmark_step,
    newmark_update_t,
    newmark_update_t_reference,
    sweep_plan,
)
