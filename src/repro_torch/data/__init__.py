"""Deterministic synthetic data, a pure function of the step."""
