"""Atomic, async checkpoints of tensor trees (`checkpoint.py`)."""
