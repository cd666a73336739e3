"""Parallelism of the port: rank groups and the data-parallel gradient
sync (``group.py``, ``dp.py``), and the attention helpers (single-rank
paths so far)."""
