"""Host-side (numpy) mesh code, carried over from the JAX package so that the
port never imports it (importing ``vf_fem_tpu`` loads jax)."""

from .core import Mesh, sort_vertices_by_nearest_neighbours
from .primitives import vocal_fold_mesh
from .gmsh_io import load_gmsh
from .interface import derive_1d_interface
