"""
Functionals mapping solved trajectories to scalars (counterpart of
``vf_fem_tpu.functional``; ``functional/acoustic.py`` waits for the
acoustic models).
"""

from . import base, fluid, fsi, solid
from .base import AbstractFunctional, Scalar
