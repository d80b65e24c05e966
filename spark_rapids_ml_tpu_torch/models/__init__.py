"""Estimators and models of the port (one module per JAX counterpart)."""
