"""PyTorch/CUDA port of pafuse_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package module by module (``skeleton``, ``geometry``,
``data.windows``, ``models.mixste``, ``models.parts``, ``diffusion``,
``checkpoints``, ``serve``); the fused transformer block runs as a
hand-written CUDA kernel (``ops/csrc/block.cu``).  Imports torch, numpy and
the standard library only.
"""
