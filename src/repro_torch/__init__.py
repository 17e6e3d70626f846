"""PyTorch + CUDA port of the Hercule in-transit stack (``repro``'s twin).

Same layout as the JAX package (``core``, ``sim``, ``hercule``, ``obs``,
``kernels``, ``insitu``, ``launch``), written against torch, numpy and
the stdlib only. The device-reduce path runs hand-written CUDA raster
kernels (``kernels/csrc/raster.cu``) on an NVIDIA GPU; every kernel has
a plain torch twin that the CPU path uses.
"""
