"""Parallelism of the port: rank groups on the JAX mesh and the
data-parallel gradient sync (``group.py``, ``dp.py``), tensor and expert
parallelism (``tp.py``, ``ep.py``), and the attention over the sequence
axis (``ring_attention.py``)."""
