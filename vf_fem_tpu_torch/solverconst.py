"""Default Newton solver parameters (the JAX package's
``solverconst.DEFAULT_NEWTON_SOLVER_PRM``).

Keys read beside these (``models.transient``, ``solvers.newton``,
``forward.integrate_pure``) and their defaults when absent:

- ``krylov_tolerance`` (1e-8) and ``krylov_max_iter`` (1000): the Krylov
  stopping rule of ``linear_solver='cg'``/``'bsb'``, iterate while
  ``||r|| > max(krylov_tolerance ||b||, 1e-12)`` and fewer than
  ``krylov_max_iter`` iterations ran;
- ``krylov`` ('bicgstab'; or 'pcg' for symmetric problems);
- ``btd_store_dtype`` (None): with ``linear_solver='btd'`` or 'spike'
  (block-Thomas direct solves on the block-banded Jacobian,
  ``solvers.btd``), None keeps the factors in the model's dtype;
  'bfloat16', 'float8_e4m3fn' or 'float8_e5m2' stores them below it (their
  matvecs cast the vector to bf16 and sum in f32); ``btd_offdiag_dtype``
  (None: ``btd_store_dtype``) stores the sweeps' arrays apart from
  ``Sinv``; ``btd_factor_dtype`` (None; 'float32') factors in f32 under the
  residual's f64;
- ``initial_guess`` ('predictor'; 'given', 'extrapolated');
- ``jacobian_update``: 'every_iteration' for 'dense', 'once_per_step' for
  the element-block solvers ('cg', 'bsb', 'btd');
- ``stagnation_ratio`` (0.9), ``fixed_iterations``, ``fixed_tail_residual``
  (True), ``assembly`` ('auto'), ``jacobian_refresh_steps`` (1),
  ``jacobian_refresh_mode`` ('full'), ``jacobian_full_refresh_windows`` (8),
  ``jacobian_refresh_iters`` (2).
"""

DEFAULT_NEWTON_SOLVER_PRM = {
    "linear_solver": "dense",
    "absolute_tolerance": 1e-8,
    "relative_tolerance": 1e-10,
    "maximum_iterations": 50,
}

# the Picard (fixed-point) loop of the implicit coupling and the static
# solvers (``solvers.newton.iterative_solve``); its stagnation ratio
# defaults to 0.98 there
FIXEDPOINT_SOLVER_PRM = {
    "absolute_tolerance": 1e-8,
    "relative_tolerance": 1e-11,
    "maximum_iterations": 50,
}
