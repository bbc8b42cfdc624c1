"""Offline extraction throughput: every image collected in the window over
the whole window (``infer_items_per_s``'s reading, under its own name and
bound)."""

from benchmark import harness

read = harness.load_module("metrics", "infer_items_per_s").read
