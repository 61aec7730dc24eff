"""Algebraic mesh: the light-weight topology AMG coarsens.

Copied from ngsamg_tpu/mesh/topo.py: the ``AlgebraicMesh`` container, which
the structured fast path uses as a placeholder mesh per level. The edge
helpers that reach the native extension wait for the generic level loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AlgebraicMesh:
    """Vertices + edges + attached data (host-side, setup phase)."""

    nv: int
    edges: np.ndarray  # (ne, 2) int64, sorted i < j, unique
    vertex_data: dict = field(default_factory=dict)  # name -> (nv, ...) array
    edge_data: dict = field(default_factory=dict)  # name -> (ne, ...) array
