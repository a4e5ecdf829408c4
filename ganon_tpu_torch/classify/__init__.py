"""Classify: device batch path, thresholds, LCA and the engine."""
