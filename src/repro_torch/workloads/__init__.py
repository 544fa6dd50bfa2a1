"""Emulated workloads (the paper's Table I Spark jobs)."""
