"""
Global configuration of the PyTorch/CUDA port.

- Working dtype: float64 by default on CPU and GPU alike (the H100 has
  native f64 LU, so the port needs none of the JAX package's
  f32-on-device workarounds); float32 is an option per model
  (``load_fsi_model(..., dtype=torch.float32)``).
- Matmul precision: FEM residuals mix Newmark mass terms ~1/(beta dt^2)
  with O(1) traction terms, so matmul rounding shows up at once as Newton
  stagnation.  TF32 (Hopper's reduced-precision f32 matmul path) keeps
  ~3 decimal digits, like the single-pass bf16 that breaks Newton on a
  TPU, so every f32 product here stays in full f32.
- ``BANDED_GC``: cells per group of the banded assembly plan
  (``fem.banded``), the same value as the JAX package's default.
"""

import torch

DEFAULT_DTYPE = torch.float64

BANDED_GC: int = 256


def pin_full_fp32_matmul() -> None:
    """Keep float32 matmuls and convolutions out of TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


pin_full_fp32_matmul()
