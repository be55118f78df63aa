"""
PyTorch/CUDA port of the explicit-FSI forward path of ``vf_fem_tpu``.

The JAX package ``vf_fem_tpu`` is the reference this port is tested
against; the port never imports it (nor jax).  Entry points:
``load.load_fsi_model(mesh, ..., device=, dtype=)`` and
``forward.integrate_pure``.
"""

from . import config  # noqa: F401  (pins full-precision f32 matmuls)
