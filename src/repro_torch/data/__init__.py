"""Data pipeline."""
