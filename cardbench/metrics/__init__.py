"""Metric readers, one file each, named as in BENCHMARK.json."""
