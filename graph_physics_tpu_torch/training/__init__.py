"""Batching, the train step, rollout, the trainer, checkpoints and config
of the port."""
