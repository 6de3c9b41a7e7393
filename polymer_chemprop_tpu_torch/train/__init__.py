"""Prediction from checkpoints."""
