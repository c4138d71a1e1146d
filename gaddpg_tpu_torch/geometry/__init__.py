"""Geometry constants and transforms."""
