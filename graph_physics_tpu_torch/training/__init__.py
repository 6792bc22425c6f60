"""Batching and rollout of the port."""
