"""The benchmark harness of the PyTorch and CUDA port: one cell, one run."""
