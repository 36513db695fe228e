"""Optimizers, learning-rate policies and checkpoints of the port."""
