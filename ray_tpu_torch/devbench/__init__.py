"""Profiling entry points of the port, each the counterpart of a script in
the JAX package's ``devbench/``; run as ``python -m
ray_tpu_torch.devbench.<name>``.

- ``prof_flash_pack``: the head-packed flash-attention forward kernels
  (K8, K9, K10: three mask schedules) against K2, checked and timed.
- ``capture_cost``: what a ``capture_profile`` costs the 1.1B training
  step it watches (the stack sampler, the device trace, the GC).
"""
