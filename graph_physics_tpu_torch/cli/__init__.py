"""Command-line entry points of the port: ``python -m
graph_physics_tpu_torch.cli.train`` and ``...cli.predict``."""
