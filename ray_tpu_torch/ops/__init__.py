"""Ops of the PyTorch port: hand-written CUDA kernels with their plain
PyTorch versions (norms, attention and its ring-step chunk variant), ring
attention over a torch.distributed group, and plain tensor code (rope,
loss)."""
