"""ngsamg_tpu_torch — the ngsamg_tpu algebraic multigrid on PyTorch + CUDA.

A port of :mod:`ngsamg_tpu` (JAX, TPU) that mirrors its layout module by
module. The host setup is numpy/scipy (copies of the JAX package's host
modules, since importing that package needs JAX); the solve phase runs on
torch tensors, with hand-written CUDA kernels (``csrc/``) for the matvecs
the JAX package wrote in Pallas. It imports neither JAX nor ngsamg_tpu.

Public API:
    AMGPreconditioner / amg_preconditioner — strict-algebraic-mode front-end
    AMGOptions, options_from_flags, SpecOpt — configuration
    apps.h1.H1Energy, apps.elasticity.ElasticityEnergy — PDE energies
    precond.stokes.StokesAMG / StokesHDivAMG / StokesHDGEmbeddedAMG —
        Stokes facet AMG (imported from there, as in the JAX package)
    utils.fem, utils.stokes_fem — problem generators
"""

from .config import (
    AMGOptions,
    CoarsenType,
    CoarseSolveType,
    CycleType,
    ProlType,
    SmootherOptions,
    SmootherType,
    SpecOpt,
    options_from_flags,
)
from .precond.amg import AMGPreconditioner, amg_preconditioner

__version__ = "0.1.0"

__all__ = [
    "AMGOptions",
    "AMGPreconditioner",
    "amg_preconditioner",
    "CoarsenType",
    "CoarseSolveType",
    "CycleType",
    "ProlType",
    "SmootherOptions",
    "SmootherType",
    "SpecOpt",
    "options_from_flags",
]
