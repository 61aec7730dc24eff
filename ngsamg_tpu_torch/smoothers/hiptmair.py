"""Hiptmair two-space smoother (device).

Port of ngsamg_tpu/smoothers/hiptmair.py, the reference's
`HiptMairSmoother` (base_smoother.hpp:290-345): smooth in the range
(velocity) space, map the residual into the potential space through the
discrete curl C (r_pot = C^T r), smooth the potential-space operator
A_pot = C^T A C from a zero guess, and map the correction back
(x += C x_pot). Essential for grad-div-penalized (Stokes) operators whose
near-null space is the divergence-free (curl) range.

The forward sweep smoothes range -> potential; the backward sweep reverses
the order, making the symmetric pair usable inside PCG. Plain torch, as
the original is XLA: the matvecs go through ``formats.matvec``, so a DIA
``A_pot`` runs the DIA kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..sparse.formats import matvec
from .core import Smoother, smooth as _smooth, smooth_back as _smooth_back


@dataclass(frozen=True)
class HiptmairSmoother:
    """range smoother + potential smoother + curl matrix pair."""

    range_sm: Smoother
    pot_sm: Smoother
    A_pot: object  # potential-space operator (any matvec format)
    C: object  # potential -> range (curl)
    CT: object  # range -> potential


def hiptmair_smooth(sm: HiptmairSmoother, A, x, b, *, reverse: bool):
    def pot_correction(x):
        r = b - matvec(A, x)
        r_pot = matvec(sm.CT, r)
        if reverse:
            x_pot = _smooth_back(sm.pot_sm, sm.A_pot, None, r_pot)
        else:
            x_pot = _smooth(sm.pot_sm, sm.A_pot, None, r_pot)
        return x + matvec(sm.C, x_pot)

    if not reverse:
        x = _smooth(sm.range_sm, A, x, b)
        x = pot_correction(x)
    else:
        if x is None:
            x = torch.zeros_like(b)
        x = pot_correction(x)
        x = _smooth_back(sm.range_sm, A, x, b)
    return x
