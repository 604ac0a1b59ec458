"""PyTorch + CUDA port of bear_tpu for NVIDIA Hopper cards.

The subpackages mirror ``bear_tpu`` (``ops``, ``counting``, ``models``,
``inference``, ``utils``) so each module sits beside the JAX module it
replaces. This package imports ``torch`` and numpy only: never ``jax`` and
nothing of ``bear_tpu``.

Entry points take ``device="cuda"`` by default. A CUDA tensor runs the
hand-written kernels (``csrc/``, built with ``nvcc`` at first use) or
raises; a CPU tensor (``device="cpu"``) runs each kernel's plain PyTorch
version.
"""
