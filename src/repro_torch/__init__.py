"""repro_torch — the PyTorch / CUDA port of the ``repro`` model stack.

The package mirrors ``repro``'s layout (``configs``, ``models``, ``kernels``,
``train``, ``launch``) so that each module's counterpart is found by path.
It imports ``torch`` and numpy only: never ``jax`` and never a module of
``repro``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the kernels under ``kernels/*/csrc`` are hand-written CUDA
C++ for Hopper (``sm_90a``), built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
