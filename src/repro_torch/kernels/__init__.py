"""Hand-written Hopper kernels, their plain PyTorch versions, and the
dispatch shell (port of ``repro/kernels``).  Nothing here compiles or
imports a GPU toolchain at import time."""
