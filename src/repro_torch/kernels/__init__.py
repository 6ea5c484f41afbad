"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel lives in ``<name>/csrc/*.cu`` beside ``<name>/ref.py`` (the plain
version) and ``<name>/ops.py`` (the wrapper); ``_build`` compiles the sources
with ``nvcc`` at first use.
"""
