"""Default Newton solver parameters (the JAX package's
``solverconst.DEFAULT_NEWTON_SOLVER_PRM``)."""

DEFAULT_NEWTON_SOLVER_PRM = {
    "linear_solver": "dense",
    "absolute_tolerance": 1e-8,
    "relative_tolerance": 1e-10,
    "maximum_iterations": 50,
}
