"""Synthetic audio, dataset writers and dataset loading of the port."""
