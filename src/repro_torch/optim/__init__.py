"""Local optimizers and primal solvers."""
