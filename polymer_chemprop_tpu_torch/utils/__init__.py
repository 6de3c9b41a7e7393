"""Checkpoint input/output."""
