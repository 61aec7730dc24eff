"""Transport interface: the distributed setup's communication boundary.

Copied from ngsamg_tpu/parallel/transport.py, with its
``CollectiveTransport`` rewritten for ``torch.distributed``. The
reference reaches every process boundary
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
* :class:`CollectiveTransport` — one rank per shard of a
  ``torch.distributed`` world (parallel/world.py): every exchange is one
  ``all_to_all_single`` of uint32 words on the mesh's device, payloads
  bucket-padded per (source, destination) pair, with the items' source
  positions riding along. In torch a collective has one process per rank,
  so this transport is multi-controller (``my_shards`` is the rank's own
  shard), run by mp_runtime's rank-local level loops in a spawned world;
  it replaces the JAX module's single-controller stand-in, which
  attributed the controller's items to source shards by position.

Payloads cross the device boundary bit-cast to uint32 words, so f64/i64
values round-trip EXACTLY, and each destination receives its items in
(source rank, source position) order — the order a single controller
sees — so the collective-transport hierarchy is bitwise the local one
(asserted by tests/test_torch_collective_transport.py).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import scipy.sparse as sp

__all__ = [
    "Transport",
    "LocalTransport",
    "CollectiveTransport",
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


def _bucket(n: int) -> int:
    """Next power of two (bounds the distinct slot sizes)."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


def _to_u32(a: np.ndarray) -> np.ndarray:
    """(m, ...) array -> (m, words) uint32 view-copy (exact bit transport).

    Sub-word dtypes (bool/int8/int16) widen to int32 words first."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize < 4:
        a = np.ascontiguousarray(a.astype(np.int32))
    m = a.shape[0]
    words = (a.dtype.itemsize * int(np.prod(a.shape[1:], initial=1))) // 4
    if m == 0:
        return np.zeros((0, max(words, 1)), dtype=np.uint32)
    return a.view(np.uint32).reshape(m, -1)


def _from_u32(w: np.ndarray, dtype, tail_shape) -> np.ndarray:
    m = w.shape[0]
    dtype = np.dtype(dtype)
    if dtype.itemsize < 4:
        out = np.ascontiguousarray(w).view(np.int32).astype(dtype)
    else:
        out = np.ascontiguousarray(w).view(dtype)
    return out.reshape((m,) + tuple(tail_shape))


def _words(a: np.ndarray) -> int:
    return max(1, (max(a.dtype.itemsize, 4)
                   * int(np.prod(a.shape[1:], initial=1))) // 4)


class CollectiveTransport(Transport):
    """Exchanges executed as ``all_to_all_single`` rounds of a
    ``torch.distributed`` world, one rank per shard.

    Every primitive is built on ``_route(dest, arrays)``: each rank's items
    (uint32 word rows of the arrays, plus their source position) go to
    their destination ranks in one all-to-all, each (source, destination)
    block padded to a power-of-two slot count that every rank agrees on
    (an all-gather of the per-destination counts, which also checks that
    the ranks' payloads have the same word layout). gather and
    gather_csr_rows are two-phase (requests to owners, replies back), the
    reference's request/reply DCC exchanges (dcc_map.hpp:20-134). The
    words live on ``mesh.device``.
    """

    name = "collective"

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank = int(mesh.rank)
        self.n = int(mesh.size)
        self.device = mesh.device
        self.calls = 0
        self.moved_words = 0
        self.moved_bytes = 0

    def my_shards(self, n_shards: int):
        assert n_shards == self.n, (n_shards, self.n)
        return (self.rank,)

    # -- the one collective ------------------------------------------------
    def _route(self, dest: np.ndarray, arrays: tuple):
        """Send item i (row i of every array) to rank dest[i]; returns
        (per-source received arrays, per-source source positions), each
        source's items in its position order."""
        import torch
        import torch.distributed as dist

        n, me = self.n, self.rank
        dest = np.asarray(dest, dtype=np.int64)
        arrays = tuple(np.asarray(a) for a in arrays)
        m = len(dest)
        order = np.argsort(dest, kind="stable")  # by dest, then position
        counts = np.bincount(dest, minlength=n).astype(np.int64)
        layout = [_words(a) for a in arrays] + [
            ord(a.dtype.char) for a in arrays
        ]
        meta = torch.from_numpy(
            np.concatenate([counts, np.asarray(layout, np.int64)])
        ).to(self.device)
        allmeta = meta.new_empty(n * meta.numel())
        dist.all_gather_into_tensor(allmeta, meta)
        allmeta = allmeta.cpu().numpy().reshape(n, -1)
        if not (allmeta[:, n:] == allmeta[me, n:]).all():
            raise ValueError(
                "CollectiveTransport: the ranks route payloads of different "
                f"word layouts {allmeta[:, n:].tolist()}"
            )
        allc = allmeta[:, :n]  # [source, destination] item counts
        cap = _bucket(int(allc.max()))
        u32s = [_to_u32(a[order]) for a in arrays]
        # position tag: the item's position at its source
        u32s.append(_to_u32(order.astype(np.int64)))
        widths = [u.shape[1] for u in u32s]
        W = sum(widths)
        buf = np.zeros((n, cap, W), dtype=np.uint32)
        if m:
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            slot = np.arange(m) - starts[dest[order]]
            buf[dest[order], slot] = np.concatenate(u32s, axis=1)
        send = torch.from_numpy(buf.view(np.int32).reshape(-1)).to(
            self.device
        )
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        got = recv.cpu().numpy().view(np.uint32).reshape(n, cap, W)
        self.calls += 1
        self.moved_words += int(buf.size)
        self.moved_bytes += int(buf.nbytes)
        cuts = np.concatenate([[0], np.cumsum(widths)])
        per_src, per_pos = [], []
        for s in range(n):
            rows = got[s, : int(allc[s, me])]
            per_src.append(tuple(
                _from_u32(rows[:, cuts[k]:cuts[k + 1]], a.dtype, a.shape[1:])
                for k, a in enumerate(arrays)
            ))
            per_pos.append(_from_u32(rows[:, cuts[-2]:], np.int64, ()))
        return per_src, per_pos

    # -- primitives ---------------------------------------------------------
    def gather(self, parts, starts, idx):
        local = np.asarray(parts[self.rank])
        idx = np.asarray(idx, dtype=np.int64)
        if len(idx):
            assert idx.min() >= 0 and idx.max() < starts[-1], "unowned index"
        own = _owner(starts, idx)
        reqs, req_pos = self._route(own, (idx,))
        # serve: my rows for every requester, routed back with the
        # requester's positions
        vals = [local[r[0] - starts[self.rank]] for r in reqs]
        back_dest = np.concatenate([
            np.full(len(r[0]), s, dtype=np.int64) for s, r in enumerate(reqs)
        ])
        reps, _ = self._route(
            back_dest,
            (np.concatenate(vals).reshape((-1,) + local.shape[1:])
             .astype(local.dtype, copy=False),
             np.concatenate(req_pos)),
        )
        out = np.empty((len(idx),) + local.shape[1:], dtype=local.dtype)
        for v, posn in reps:
            out[posn] = v
        return out

    def reduce_by_owner(self, starts, idx, vals, n_local):
        own = _owner(starts, np.asarray(idx, dtype=np.int64))
        routed, _ = self._route(
            own,
            (np.asarray(idx, np.int64), np.asarray(vals, np.float64)),
        )
        acc = np.zeros(n_local[self.rank], dtype=np.float64)
        # single-controller order: sources ascending, each in local order
        gi = np.concatenate([r[0] for r in routed])
        v = np.concatenate([r[1] for r in routed])
        np.add.at(acc, gi - starts[self.rank], v)
        out = [None] * self.n
        out[self.rank] = acc
        return out

    def route_coo(self, starts_row, ri, cj, vv, ncols):
        own = _owner(starts_row, np.asarray(ri, dtype=np.int64))
        routed, _ = self._route(
            own,
            (
                np.asarray(ri, np.int64),
                np.asarray(cj, np.int64),
                np.asarray(vv, np.float64),
            ),
        )
        r0 = int(starts_row[self.rank])
        nloc = int(starts_row[self.rank + 1]) - r0
        gi = np.concatenate([r[0] for r in routed])
        gj = np.concatenate([r[1] for r in routed])
        v = np.concatenate([r[2] for r in routed])
        if len(gi):
            M = sp.coo_matrix(
                (v, (gi - r0, gj)), shape=(nloc, ncols)
            ).tocsr()
            M.sum_duplicates()
        else:
            M = sp.csr_matrix((nloc, ncols))
        out = [None] * self.n
        out[self.rank] = M
        return out

    def route_rows(self, starts, idx, arrays):
        idx = np.asarray(idx, dtype=np.int64)
        own = _owner(starts, idx)
        routed, _ = self._route(own, tuple(arrays))
        # sources ascending, each in source-position order (the
        # single-controller order)
        out = [None] * self.n
        out[self.rank] = tuple(
            np.concatenate([r[k] for r in routed])
            for k in range(len(arrays))
        )
        return out

    def gather_csr_rows(self, parts, starts, rows_g, ncols):
        local = parts[self.rank]
        rows_g = np.asarray(rows_g, dtype=np.int64)
        own = _owner(starts, rows_g)
        reqs, req_pos = self._route(own, (rows_g,))
        # owners flatten the requested rows to (request position, column,
        # value) items, row by row in stored order, routed back
        ri, cj, vv, dst = [], [], [], []
        for s, (r, p) in enumerate(zip(reqs, req_pos)):
            sub = local[r[0] - starts[self.rank]].tocsr()
            lens = np.diff(sub.indptr)
            ri.append(np.repeat(np.asarray(p, np.int64), lens))
            cj.append(np.asarray(sub.indices, np.int64))
            vv.append(np.asarray(sub.data, np.float64))
            dst.append(np.full(sub.nnz, s, dtype=np.int64))
        back, _ = self._route(
            np.concatenate(dst),
            (np.concatenate(ri), np.concatenate(cj), np.concatenate(vv)),
        )
        # each row comes from exactly one owner; a stable sort by request
        # position keeps in-row column order intact
        rows = np.concatenate([b[0] for b in back])
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(len(rows_g) + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(rows, minlength=len(rows_g)))
        return sp.csr_matrix(
            (
                np.concatenate([b[2] for b in back])[order],
                np.concatenate([b[1] for b in back])[order],
                indptr,
            ),
            shape=(len(rows_g), ncols),
        )

    # -- replicated-metadata collectives ------------------------------------
    def _allgather_rows(self, arr: np.ndarray) -> list:
        """Every rank's ``arr`` (rows routed to every rank)."""
        arr = np.asarray(arr)
        m = arr.shape[0]
        dest = np.repeat(np.arange(self.n, dtype=np.int64), m)
        rep = np.concatenate([arr] * self.n) if self.n else arr
        got, _ = self._route(dest, (rep,))
        return [g[0] for g in got]

    def allgather(self, arr):
        return np.concatenate(
            self._allgather_rows(np.atleast_1d(np.asarray(arr)))
        )

    def allgather_parts(self, parts):
        return np.concatenate(
            self._allgather_rows(np.asarray(parts[self.rank]))
        )

    def allreduce_any(self, flag):
        return bool(self.allgather(np.asarray([bool(flag)])).any())


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
