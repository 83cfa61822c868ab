"""PyTorch/CUDA port of tchvp_tpu for one NVIDIA H100.

The JAX package ``tchvp_tpu`` is the reference; this package mirrors its
module layout and public layouts, imports ``torch`` and numpy only, and
runs every kernel of its path as a hand-written Hopper kernel.
"""
