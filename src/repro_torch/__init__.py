"""PyTorch/CUDA port of the concave-speedup scheduling library.

Mirrors ``repro`` module by module (``core/speedup.py``, ``core/gwf.py``,
``kernels/gwf_waterfill/`` …) and imports nothing of it or of JAX.
Entry points run on CUDA unless given ``device="cpu"`` or CPU tensors.
"""
