"""Numpy-only data generators of the §6.1 worlds (own copies)."""
