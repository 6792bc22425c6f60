"""Data sources of the port: h5 trajectories, frame building, the
bucketed loader and synthetic trajectories."""
