"""Ops of the PyTorch port: hand-written CUDA kernels with their plain
PyTorch versions (norms), and plain tensor code (rope)."""
