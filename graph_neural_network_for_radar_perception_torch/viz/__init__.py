"""Plots and sequence viewers over the port's detections (matplotlib)."""
