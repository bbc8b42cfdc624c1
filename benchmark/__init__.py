"""The benchmark of the PyTorch and CUDA port (``vltk_tpu_torch``); see ``harness.py``."""
