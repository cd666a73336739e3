"""Metrics registry and device-time attribution of the port."""
