"""PyTorch and CUDA port of spine_vision_tpu for NVIDIA Hopper GPUs.

The JAX package ``spine_vision_tpu`` is the reference; this package imports
nothing of it, nor JAX. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""
