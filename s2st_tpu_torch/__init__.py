"""s2st_tpu_torch: the PyTorch / CUDA port of s2st_tpu for NVIDIA Hopper.

The JAX package ``s2st_tpu`` stays the reference; this package imports
nothing of it and keeps its own copies of what it needs. Module layout
mirrors ``s2st_tpu`` (``nn/``, ``models/``, ``generate/``, ``ops/``,
``data/``, ``cli/``); hand-written CUDA kernels live in ``csrc/`` with
their Python wrappers and plain PyTorch versions in ``kernels/``.
"""
