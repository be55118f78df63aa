"""
Physical constants in CGS units (a copy of ``vf_fem_tpu.constants``, which
the port does not import).

Mirrors the unit conventions of the reference library
(reference: ``src/femvf/constants.py:1-11``): all quantities are in
centimetre-gram-second units, so pressures are in barye
(1 Pa = 10 barye = 10 dyn/cm^2).
"""

PASCAL_TO_CGS = 10.0
"""Conversion factor from Pa to dyn/cm^2 (barye)."""

SI_DENSITY_TO_CGS = 1e-3
"""Conversion factor from kg/m^3 to g/cm^3."""

SI_VISCOSITY_TO_CGS = 10.0
"""Conversion factor from Pa*s to poise."""

DEFAULT_FLUID_RHO = 1.1225 * SI_DENSITY_TO_CGS
"""Density of air at ~15 C in g/cm^3."""

DEFAULT_SOLID_RHO = 1.0
"""Default vocal-fold tissue density, g/cm^3 (~water)."""
