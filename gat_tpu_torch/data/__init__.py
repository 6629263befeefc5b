"""Synthetic audio of the port."""
