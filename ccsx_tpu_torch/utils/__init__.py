"""Utilities: device resolution, synthetic data, trace stubs."""
