"""PyTorch/CUDA port of the concave-speedup scheduling library.

Mirrors ``repro`` module by module (``core/``, ``configs/``, ``models/``,
``serve/``, ``launch/``, ``kernels/`` …) and imports nothing of it or of
JAX.
Entry points run on CUDA unless given ``device="cpu"`` or CPU tensors.
"""
