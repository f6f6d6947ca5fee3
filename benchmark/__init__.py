"""The benchmark of the PyTorch/H100 port: see README.md."""
