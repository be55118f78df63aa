"""
Functionals mapping solved trajectories to scalars (counterpart of
``vf_fem_tpu.functional``), the acoustic ones (``functional/acoustic.py``)
included.
"""

from . import acoustic, base, fluid, fsi, solid
from .base import AbstractFunctional, Scalar
