"""Dependency-free helpers: ``tbevents`` (TensorBoard event files)."""
