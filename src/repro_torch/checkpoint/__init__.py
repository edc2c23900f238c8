"""Atomic checkpoints of tensor trees (`store`)."""
