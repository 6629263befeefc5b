"""Checkpoint reading (training is not ported yet)."""
