"""PyTorch/CUDA port of the ``repro`` HGNN system, for NVIDIA Hopper.

The package mirrors ``src/repro/`` module by module: ``repro_torch/<path>.py``
ports ``repro/<path>.py`` and is tested against it on the same inputs.  It
imports ``torch``, numpy and scipy, never jax and never anything of
``repro``.

Importing the package builds nothing and imports no GPU toolchain: the hand
written CUDA kernels under ``kernels/csrc/`` are compiled by ``nvcc`` at
their first launch on a CUDA tensor (``kernels/build.py``).  Entry points
run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
