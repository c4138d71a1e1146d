"""Precision and device helpers, rollout videos and episode recording."""
