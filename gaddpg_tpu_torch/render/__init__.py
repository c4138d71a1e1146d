"""Wrist-camera rendering and the accumulated point-cloud state."""
