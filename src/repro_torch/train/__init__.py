"""Artifact persistence: atomic, generation-stamped checkpoints."""
