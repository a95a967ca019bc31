"""Rigid transforms, registration metrics and the Kabsch solvers."""
