"""Data pipelines: deterministic synthetic generators, numpy only."""
