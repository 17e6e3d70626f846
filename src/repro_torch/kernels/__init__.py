"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers and plain
torch twins (``ref``), behind the ``ops`` entry points."""
