"""Metrics registry of the port."""
