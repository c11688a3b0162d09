"""Build-on-first-use for the CUDA sources in ``ray_tpu_torch/csrc``."""
