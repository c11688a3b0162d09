"""Serving helpers of the PyTorch port (prefix hashing only so far)."""
