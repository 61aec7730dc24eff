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

__version__ = "0.1.0"


def __getattr__(name):
    # the front end (and torch with it) loads on first use, so that host
    # modules import without torch: the multi-process setup's numpy ranks
    # (parallel/mp_runtime.py) start without it
    if name in ("AMGPreconditioner", "amg_preconditioner"):
        from .precond import amg

        return getattr(amg, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
