"""Host-side (numpy) mesh code, carried over from the JAX package so that the
port never imports it (importing ``vf_fem_tpu`` loads jax): the mesh, its
gmsh reader and writer, the primitive generators, the extruder and the M5 mesher (the
numpy path of the JAX package's, without its native C++ kernels)."""

from .core import Mesh, sort_vertices_by_nearest_neighbours
from .primitives import (
    mark_unit_mesh_fixtures,
    unit_cube_mesh,
    unit_square_mesh,
    vocal_fold_mesh,
)
from .gmsh_io import load_gmsh
from .interface import derive_1d_interface, locate_separation_vertex
from .m5 import m5_mesh, m5_profile_names
from .writers import write_gmsh
