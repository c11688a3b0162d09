"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` that imports ``torch`` and nothing of JAX or
of ``ray_tpu``. Ported so far: the LLM serving engine (``ray_tpu_torch.llm``)
with its model geometry (``models``), ops (``ops``: the CUDA RMSNorm kernel
and RoPE) and prefix hashing (``serve.prefix``). Importing the package is
cheap: CUDA kernels are built from ``csrc/`` at their first launch.
"""

__version__ = "0.1.0"
