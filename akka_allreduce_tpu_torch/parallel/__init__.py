"""Parallel-attention helpers of the port (single-rank paths only so far)."""
