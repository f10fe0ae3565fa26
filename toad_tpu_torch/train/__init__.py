"""Fold training: optimizer, checkpoints, the per-fold loop."""
