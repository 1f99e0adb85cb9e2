"""Numerical kernels: KKT algebra, compact quasi-Newton, native sparse."""
