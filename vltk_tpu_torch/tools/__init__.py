"""Command-line probes and micro-benchmarks of the port's kernels, run as
``python -m vltk_tpu_torch.tools.<name>``. Nothing runs at import."""
