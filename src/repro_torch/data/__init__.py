"""Synthetic history generators."""
