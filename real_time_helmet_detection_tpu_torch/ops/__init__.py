"""Kernels of the port: hand-written CUDA with plain PyTorch versions.

Importing the package registers the `helmet` operator namespace
(`ops.library`), through which the eval wrappers reach their kernels.
"""

from . import library  # noqa: F401
