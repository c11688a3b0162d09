"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` that imports ``torch`` and nothing of JAX or
of ``ray_tpu``. Ported so far: the LLM serving engine (``ray_tpu_torch.llm``)
and prefix hashing (``serve.prefix``); the single-card training step
(``train``: ``make_llama_train_step``, ``adamw``, ``adamw_lowmem``); the
Llama model with its training forward and remat (``models``); ops
(``ops``: the CUDA RMSNorm and flash-attention forward/backward kernels,
RoPE, the fused cross-entropy); peak rates for MFU (``accelerators``).
Importing the package is cheap: CUDA kernels are built from ``csrc/`` at
their first launch.
"""

__version__ = "0.1.0"
