"""Production entry points (solve_auto) and the solver probe."""
