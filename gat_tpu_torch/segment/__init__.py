"""Segmentation of the file path: gating and onset slicing."""
