"""Checkpoint reading and device resolution."""
