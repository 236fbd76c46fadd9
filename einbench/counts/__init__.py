"""The benchmark's own counts of the work."""
