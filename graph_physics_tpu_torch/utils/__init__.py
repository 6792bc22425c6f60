"""Utilities of the port (the weight bridge from the JAX package)."""
