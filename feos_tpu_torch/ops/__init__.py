"""Automatic-differentiation helpers."""
