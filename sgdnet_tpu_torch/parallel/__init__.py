"""Fold-parallel cross-validation (parallel/cv.py)."""
