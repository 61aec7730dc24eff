"""Energy abstraction: what an AMG application must provide.

Copied from ngsamg_tpu/apps/base.py, cut to what the structured fast path
reads: the DOFs per vertex. The abstract
mesh-energy methods (finest mesh, strength, transport, replacement matrix,
data mapping) arrive with the generic level loop, which is the only
consumer of them.
"""

from __future__ import annotations


class Energy:
    """PDE-specific energy (see ngsamg_tpu/apps/base.py for the full
    contract)."""

    #: DOFs per vertex in the AMG space (1..3 H1, 3/6 elasticity)
    dpv: int
