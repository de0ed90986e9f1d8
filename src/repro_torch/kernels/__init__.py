"""The port's kernels: each a hand-written CUDA kernel for Hopper
(``csrc/``), its ctypes wrapper, and its plain PyTorch version (``ref``).
``ops`` picks between them by the device of the input."""
