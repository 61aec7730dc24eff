"""Transport interface: the distributed setup's communication boundary.

Copied from ngsamg_tpu/parallel/transport.py without its
``CollectiveTransport`` (device collectives: the sharded solve's part,
ROADMAP queue 1 item 8b). The reference reaches every process boundary
through three MPI shapes — indexed fetches from owners
(mpiwrap_extension.hpp:17 typed gathers), owner-routed reductions
(reducetable.hpp:22 gather-reduce-scatter), and routed sparse-row shipping
(grid_contract.hpp:144-182) — and the setup in `parallel/dist_setup.py`
(+ dist_elast) funnels ALL cross-shard data movement through four
primitives with exactly those shapes:

* ``gather(parts, starts, idx)``        — values at global indices from owners
* ``reduce_by_owner(starts, idx, v, n)``— sum contributions onto owners
* ``route_coo(starts, ri, cj, vv, nc)`` — COO triples to their row owners
* ``gather_csr_rows(parts, starts, r)`` — sparse rows from their owners

Implementations:

* :class:`LocalTransport` — single-controller numpy index movement (the
  default; zero overhead).
* ``mp_runtime.MPTransport`` — one spawned OS process per shard (separate
  address spaces, pipe-mesh message passing): the execution model of the
  reference's MPI ranks, run by the same rank-local level loop via
  :meth:`Transport.my_shards`.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import scipy.sparse as sp

__all__ = [
    "Transport",
    "LocalTransport",
    "get_transport",
    "use_transport",
    "shard_nbytes",
]


def _owner(starts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.searchsorted(starts, idx, side="right") - 1


def shard_nbytes(*objs) -> int:
    """Resident bytes of one shard's numpy/scipy state (peak-memory probe)."""
    total = 0
    for o in objs:
        if o is None:
            continue
        if sp.issparse(o):
            for a in (
                getattr(o, "data", None),
                getattr(o, "indices", None),
                getattr(o, "indptr", None),
            ):
                if a is not None:
                    total += a.nbytes
        elif isinstance(o, np.ndarray):
            total += o.nbytes
        elif isinstance(o, (list, tuple)):
            total += shard_nbytes(*o)
    return total


class Transport:
    """Abstract communication boundary (one method per MPI shape).

    Single-controller transports (Local) own every shard:
    ``my_shards`` is ``range(n)`` and the replicated-metadata collectives
    (``allgather``/``allgather_parts``/``allreduce_any``) are identities —
    the caller already computed the global quantity. A true
    multi-controller transport (``mp_runtime.MPTransport``: one OS process
    per shard) overrides them with real message passing; setup code that
    iterates ``for s in transport.my_shards(n)`` and funnels every
    cross-shard access through the primitives runs unchanged under both.
    """

    name = "abstract"

    def my_shards(self, n_shards: int):
        """The shard indices THIS controller computes (all, by default)."""
        return range(n_shards)

    def gather(
        self, parts: list, starts: np.ndarray, idx: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError

    def reduce_by_owner(
        self, starts: np.ndarray, idx: np.ndarray, vals: np.ndarray,
        n_local: list,
    ) -> list:
        raise NotImplementedError

    def route_coo(self, starts_row, ri, cj, vv, ncols) -> list:
        raise NotImplementedError

    def route_rows(self, starts, idx, arrays: tuple) -> list:
        """Route aligned item rows to the owner shard of ``idx[i]``.

        ``arrays`` are item-aligned: row ``i`` of every array describes one
        item that must land on ``owner(idx[i])``. Returns a per-shard list
        (``None`` in slots owned elsewhere) of tuples of arrays holding the
        received items in DETERMINISTIC (source rank ascending, source
        position ascending) order — the order a single controller sees, so
        accumulations stay bitwise-reproducible across transports. The
        typed-table analog of the reference's ReduceTable routing
        (reducetable.hpp:22) for payloads that are not plain scalars
        (edge matrices, sort keys, weights).
        """
        raise NotImplementedError

    def gather_csr_rows(self, parts, starts, rows_g, ncols):
        raise NotImplementedError

    # -- replicated-metadata collectives (identity on one controller) ------
    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """Concatenate each controller's contribution, rank order."""
        return np.asarray(arr)

    def allgather_parts(self, parts: list) -> np.ndarray:
        """Concatenate per-shard arrays (None for shards owned elsewhere)
        into the replicated global vector."""
        return np.concatenate([np.asarray(p) for p in parts if p is not None])

    def allreduce_any(self, flag: bool) -> bool:
        return bool(flag)


class LocalTransport(Transport):
    """Single-process numpy index movement (single-controller staging)."""

    name = "local"

    def gather(self, parts, starts, idx):
        first = np.asarray(parts[0])
        if len(idx) == 0:
            return np.empty((0,) + first.shape[1:], dtype=first.dtype)
        # ownerless indices would return uninitialized memory silently
        assert idx.min() >= 0 and idx.max() < starts[-1], "unowned index"
        own = _owner(starts, idx)
        out = np.empty((len(idx),) + first.shape[1:], dtype=first.dtype)
        for s in range(len(parts)):
            m = own == s
            if m.any():
                out[m] = np.asarray(parts[s])[idx[m] - starts[s]]
        return out

    def reduce_by_owner(self, starts, idx, vals, n_local):
        out = [np.zeros(nl, dtype=np.float64) for nl in n_local]
        own = _owner(starts, idx)
        for s in range(len(out)):
            m = own == s
            if m.any():
                np.add.at(out[s], idx[m] - starts[s], vals[m])
        return out

    def route_coo(self, starts_row, ri, cj, vv, ncols):
        n_shards = len(starts_row) - 1
        own = _owner(starts_row, ri)
        out = []
        for t in range(n_shards):
            nloc = int(starts_row[t + 1] - starts_row[t])
            m = own == t
            if m.any():
                M = sp.coo_matrix(
                    (vv[m], (ri[m] - starts_row[t], cj[m])),
                    shape=(nloc, ncols),
                ).tocsr()
                M.sum_duplicates()
            else:
                M = sp.csr_matrix((nloc, ncols))
            out.append(M)
        return out

    def route_rows(self, starts, idx, arrays):
        # caller supplies its owned shards' items concatenated in shard
        # order, so selecting by owner preserves (source, position) order
        n_shards = len(starts) - 1
        own = _owner(starts, np.asarray(idx, dtype=np.int64))
        out = []
        for t in range(n_shards):
            m = own == t
            out.append(tuple(a[m] for a in arrays))
        return out

    def gather_csr_rows(self, parts, starts, rows_g, ncols):
        own = _owner(starts, rows_g)
        blocks, order = [], []
        for s in range(len(parts)):
            m = own == s
            if m.any():
                blocks.append(parts[s][rows_g[m] - starts[s]])
                order.append(np.flatnonzero(m))
        if not blocks:
            return sp.csr_matrix((0, ncols))
        stacked = sp.vstack(blocks, format="csr")
        inv = np.argsort(np.concatenate(order), kind="stable")
        return stacked[inv]


_ACTIVE: list[Transport] = [LocalTransport()]


def get_transport() -> Transport:
    """The active transport (LocalTransport unless overridden)."""
    return _ACTIVE[-1]


@contextmanager
def use_transport(t: Transport):
    """Run distributed setups with `t` as the communication backend."""
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.pop()


def __getattr__(name):
    if name == "CollectiveTransport":
        raise NotImplementedError(
            "CollectiveTransport: ROADMAP queue 1 item 8b (not ported to "
            "ngsamg_tpu_torch yet)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
