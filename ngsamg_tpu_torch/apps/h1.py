"""H1 (scalar / vector diffusion) AMG energy.

Copied from ngsamg_tpu/apps/h1.py, cut to what the structured fast path
reads (factory/levels.py checks the type and ``dpv``). The mesh-energy
methods, which reach the native setup kernels there, wait for the
unstructured slice.
"""

from __future__ import annotations

from .base import Energy


class H1Energy(Energy):
    def __init__(self, bs: int = 1):
        self.bs = bs
        self.dpv = bs
