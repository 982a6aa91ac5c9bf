"""PyTorch/CUDA port of the BCPNN system for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` module for module; the
JAX package is the reference every part of the port is held against.
The port imports ``torch`` and numpy only.  Its entry points run on the
card unless the caller passes ``device="cpu"``; the kernels in
``kernels/csrc`` are built with ``nvcc`` at first use.
"""
