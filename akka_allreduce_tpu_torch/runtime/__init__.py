"""Training-state persistence, round pacing and straggler deadlines of
the port."""
