"""Data sources of the port (in-memory synthetic trajectories so far)."""
