"""Detached equilibrium solvers."""
