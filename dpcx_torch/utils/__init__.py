"""Utilities: visualisation."""
