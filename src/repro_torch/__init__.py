"""PyTorch + CUDA port of ``repro``, held to the JAX package as its reference.

It imports ``torch``, ``numpy`` and the standard library only.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on a CPU
tensor every kernel wrapper takes its plain PyTorch version, on a CUDA
tensor it launches the hand-written Hopper kernel (``kernels/csrc``).
"""
