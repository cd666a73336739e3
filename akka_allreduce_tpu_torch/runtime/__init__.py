"""Training-state persistence of the port."""
