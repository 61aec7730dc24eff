"""Host-side (numpy/scipy) sparse utilities used during AMG setup.

Copied from ngsamg_tpu/sparse/host.py: ``block_diagonal_fast`` for the
scalar levels of the structured path (the block-size > 1 case arrives with
the block energies).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def block_diagonal_fast(A: sp.spmatrix, bs: int) -> np.ndarray:
    """Extract the (nv, bs, bs) diagonal blocks of a block matrix."""
    if bs != 1:
        raise NotImplementedError(
            "block levels are not ported to ngsamg_tpu_torch (ROADMAP "
            "queue 1 item 3)"
        )
    return A.diagonal().reshape(-1, 1, 1)
