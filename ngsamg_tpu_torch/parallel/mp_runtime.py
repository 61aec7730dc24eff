"""True multi-controller distributed setup: one OS process per shard.

Copied from ngsamg_tpu/parallel/mp_runtime.py: the scalar-H1, vector-H1,
elasticity, Stokes and HDiv Stokes setups. Besides the pipe-based
:class:`MPTransport`, every entry point takes ``transport="collective"``:
the ranks then form a ``torch.distributed`` world (parallel/world.py,
``backend`` the caller's choice) and exchange through
``transport.CollectiveTransport``, whose words live on ``device``.

The reference's distributed layer is one rank per MPI process, each
holding ONLY its rows, exchanging through typed collectives
(src/base/distributed/eqchierarchy.hpp:15-233, reducetable.hpp:22-949,
mpiwrap_extension.hpp:17). This module is that execution model:
:func:`mp_dist_setup_levels` spawns ``n`` fresh worker processes (spawn,
not fork — nothing of the parent's address space is inherited, and the
parent may hold a CUDA context), ships each worker ONLY its contiguous
row slice, and runs the SAME rank-local level loop
(`dist_setup._scalar_levels_parts`, `_vector_levels_parts`,
`dist_elast._elast_levels_parts`, `dist_stokes._stokes_levels_parts`,
`_stokes_hdiv_levels_parts`) in every worker with an
:class:`MPTransport` whose primitives move real bytes between processes
over OS pipes. The workers are numpy ranks: they start with
``CUDA_VISIBLE_DEVICES=""`` so none of them creates a CUDA context.

SPMD contract: every rank executes an identical sequence of transport
calls (the setup's loops iterate ``transport.my_shards`` = this rank's
one shard; all data-dependent control flow branches on replicated
metadata — coarse_starts, allgathered counts, allreduced flags). Each
primitive is one synchronous all-to-all round (requests), or two
(request/reply gathers) — the ReduceTable shapes.

Determinism: routed items are accumulated in (source rank, source
position) order — the exact order the single-controller transport sees —
so the multi-process hierarchy is BITWISE-equal to `dist_setup_levels`
(asserted by tests/test_torch_mp_setup.py).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from .transport import Transport

__all__ = [
    "MPTransport",
    "mp_dist_setup_levels",
    "mp_dist_stokes_levels",
    "mp_dist_stokes_hdiv_levels",
]


def _owner(starts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.searchsorted(starts, idx, side="right") - 1


class MPTransport(Transport):
    """Transport over per-rank OS processes connected by pipes.

    ``conns[other]`` is a duplex ``multiprocessing.Connection`` to rank
    ``other``. Exchanges use a deadlock-free ordered pairwise all-to-all:
    for each peer, the lower rank sends first — with every rank walking
    peers in ascending order, each blocking send is matched by a receive
    the peer reaches in bounded time.
    """

    name = "multiprocess"

    def __init__(self, rank: int, n: int, conns: dict):
        self.rank = int(rank)
        self.n = int(n)
        self.conns = conns
        self.calls = 0
        self.moved_bytes = 0

    def my_shards(self, n_shards: int):
        assert n_shards == self.n, (n_shards, self.n)
        return (self.rank,)

    # -- the one communication round ---------------------------------------
    def _alltoall(self, msgs: list):
        """msgs[other] -> that rank; returns list received per source."""
        rank, n = self.rank, self.n
        got = [None] * n
        got[rank] = msgs[rank]
        for other in range(n):
            if other == rank:
                continue
            c = self.conns[other]
            if rank < other:
                c.send(msgs[other])
                got[other] = c.recv()
            else:
                got[other] = c.recv()
                c.send(msgs[other])
        self.calls += 1
        for m in msgs:
            if isinstance(m, tuple):
                self.moved_bytes += sum(
                    a.nbytes for a in m if isinstance(a, np.ndarray)
                )
        return got

    def _route(self, dest: np.ndarray, arrays: tuple):
        """Send item i (rows arrays[k][i]) to rank dest[i]; returns
        (per-source received arrays, per-source original positions).

        Receivers see every source's items in that source's local order
        with the source's position tags — concatenating by ascending
        source rank reproduces the single-controller global order.
        """
        n = self.n
        msgs = []
        for d in range(n):
            m = dest == d
            msgs.append(
                tuple(np.ascontiguousarray(a[m]) for a in arrays)
                + (np.flatnonzero(m).astype(np.int64),)
            )
        got = self._alltoall(msgs)
        per_src = [g[:-1] for g in got]
        per_pos = [g[-1] for g in got]
        return per_src, per_pos

    # -- primitives ---------------------------------------------------------
    def gather(self, parts, starts, idx):
        local = np.asarray(parts[self.rank])
        idx = np.asarray(idx, dtype=np.int64)
        if len(idx):
            assert idx.min() >= 0 and idx.max() < starts[-1], "unowned index"
        own = _owner(starts, idx)
        reqs, req_pos = self._route(own, (idx,))
        # serve: look up my rows for every requester, reply
        replies = [
            (np.ascontiguousarray(local[r[0] - starts[self.rank]]), p)
            for r, p in zip(reqs, req_pos)
        ]
        back = self._alltoall(replies)
        out = np.empty((len(idx),) + local.shape[1:], dtype=local.dtype)
        for vals, posn in back:
            out[posn] = vals
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
        routed, _ = self._route(
            own, tuple(np.ascontiguousarray(a) for a in arrays)
        )
        # sources ascending, each in source-position order (the
        # single-controller order) — routed is already rank-indexed
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
        replies = []
        for r, p in zip(reqs, req_pos):
            sub = local[r[0] - starts[self.rank]].tocsr()
            replies.append((sub.data, sub.indices, sub.indptr, p))
        back = self._alltoall(replies)
        # reassemble rows in original request order (LocalTransport's
        # stacked[inv]): each row comes from exactly one owner; a stable
        # sort by request position keeps in-row column order intact
        all_rows, all_data, all_cols = [], [], []
        for data, indices, iptr, posn in back:
            lens = np.diff(np.asarray(iptr))
            all_rows.append(np.repeat(np.asarray(posn, np.int64), lens))
            all_data.append(np.asarray(data))
            all_cols.append(np.asarray(indices, np.int64))
        rows = np.concatenate(all_rows)
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(len(rows_g) + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(
            np.bincount(rows, minlength=len(rows_g))
        )
        return sp.csr_matrix(
            (
                np.concatenate(all_data)[order],
                np.concatenate(all_cols)[order],
                indptr,
            ),
            shape=(len(rows_g), ncols),
        )

    # -- replicated-metadata collectives ------------------------------------
    def allgather(self, arr):
        arr = np.asarray(arr)
        got = self._alltoall([arr] * self.n)
        return np.concatenate([np.atleast_1d(g) for g in got])

    def allgather_parts(self, parts):
        mine = np.asarray(parts[self.rank])
        got = self._alltoall([mine] * self.n)
        return np.concatenate(got)

    def allreduce_any(self, flag):
        got = self._alltoall([bool(flag)] * self.n)
        return any(got)


# ---------------------------------------------------------------------------
# the per-rank worker and its parent
# ---------------------------------------------------------------------------


def _rank_levels(rank, n, tr, payload, starts, energy, opts):
    """One rank's level loop under transport ``tr``: its own rows only.
    Returns (per-level records, log statistics, finest-level extras)."""
    from .transport import use_transport

    with use_transport(tr):
        if isinstance(payload, dict) and "stokes_hdiv" in payload:
            from .dist_stokes import (
                _ShardedDual,
                _stokes_hdiv_levels_parts,
            )

            (pos, vol, edges, flow, A_rows, cnt, V,
             n_special) = payload["stokes_hdiv"]
            v_starts, e_starts = starts

            def _wrap(x):
                return [x if s == rank else None for s in range(n)]

            sd = _ShardedDual(
                v_starts, e_starts, _wrap(pos), _wrap(vol),
                _wrap(edges), _wrap(flow), _wrap(A_rows),
            )
            recs, log = _stokes_hdiv_levels_parts(
                sd, _wrap(cnt), _wrap(V), n_special, opts
            )
            out = [
                {
                    "v_starts": rec["v_starts"],
                    "e_starts": rec["e_starts"],
                    "A": rec["A_parts"][rank],
                    "pos": rec["pos_parts"][rank],
                    "vol": rec["vol_parts"][rank],
                    "edges": rec["edges_parts"][rank],
                    "flow": rec["flow_parts"][rank],
                    "cnt": rec["cnt_parts"][rank],
                    "V": rec["V_parts"][rank],
                    "P": (
                        None
                        if rec["P_parts"] is None
                        else rec["P_parts"][rank]
                    ),
                    "v2agg": (
                        None
                        if rec["v2agg_parts"] is None
                        else rec["v2agg_parts"][rank]
                    ),
                }
                for rec in recs
            ]
            extra = None
        elif isinstance(payload, dict) and "stokes" in payload:
            from .dist_stokes import (
                _ShardedDual,
                _stokes_levels_parts,
            )

            pos, vol, edges, flow, A_rows, bs = payload["stokes"]
            v_starts, e_starts = starts

            def _wrap(x):
                return [x if s == rank else None for s in range(n)]

            sd = _ShardedDual(
                v_starts, e_starts, _wrap(pos), _wrap(vol),
                _wrap(edges), _wrap(flow), _wrap(A_rows),
            )
            recs, log = _stokes_levels_parts(sd, bs, opts)
            out = [
                {
                    "v_starts": rec["v_starts"],
                    "e_starts": rec["e_starts"],
                    "A": rec["A_parts"][rank],
                    "pos": rec["pos_parts"][rank],
                    "vol": rec["vol_parts"][rank],
                    "edges": rec["edges_parts"][rank],
                    "flow": rec["flow_parts"][rank],
                    "C": (
                        None
                        if rec["C_parts"] is None
                        else rec["C_parts"][rank]
                    ),
                    "P": (
                        None
                        if rec["P_parts"] is None
                        else rec["P_parts"][rank]
                    ),
                    "v2agg": (
                        None
                        if rec["v2agg_parts"] is None
                        else rec["v2agg_parts"][rank]
                    ),
                }
                for rec in recs
            ]
            extra = None
        elif isinstance(payload, tuple):  # (A rows, vertex positions)
            from .dist_elast import _elast_levels_parts

            part, pos = payload
            recs, log, finest = _elast_levels_parts(
                [part if s == rank else None for s in range(n)],
                [pos if s == rank else None for s in range(n)],
                starts,
                opts,
                energy,
            )
            out = [
                {
                    "P": rec["P_parts"][rank],
                    "P_amg": (
                        None
                        if rec["P_amg_parts"] is None
                        else rec["P_amg_parts"][rank]
                    ),
                    "v2agg": rec["v2agg_parts"][rank],
                    "Ac": rec["Ac_parts"][rank],
                    "coarse_starts": rec["coarse_starts"],
                    "c_vst": rec["c_vst"],
                    "row_bs_f": rec["row_bs_f"],
                    "cpos": rec["cpos_parts"][rank],
                    "cl2": rec["cl2_parts"][rank],
                }
                for rec in recs
            ]
            extra = {
                "pos": finest["pos_parts"][rank],
                "l2": finest["l2_parts"][rank],
            }
        else:
            bs = int(getattr(energy, "dpv", 1) or 1)
            parts_in = [
                payload if s == rank else None for s in range(n)
            ]
            if bs > 1:
                from .dist_setup import _vector_levels_parts

                recs, log = _vector_levels_parts(
                    parts_in, starts, opts, bs
                )
            else:
                from .dist_setup import _scalar_levels_parts

                recs, log = _scalar_levels_parts(
                    parts_in, starts, opts, energy
                )
            out = [
                {
                    "P": rec["P_parts"][rank],
                    "v2agg": rec["v2agg_parts"][rank],
                    "Ac": rec["Ac_parts"][rank],
                    "coarse_starts": rec["coarse_starts"],
                }
                for rec in recs
            ]
            extra = None
    return out, {
        "nvs": log.nvs,
        "nnzs": log.nnzs,
        "peak_shard_bytes": log.peak_shard_bytes,
        "finest_global_bytes": log.finest_global_bytes,
        "contract_decisions": log.contract_decisions,
        "shards_per_level": log.shards_per_level,
        "transport_calls": tr.calls,
        "moved_bytes": tr.moved_bytes,
    }, extra


def _mp_worker(rank, n, conns, parent, payload, starts, energy, opts):
    """One rank of the pipe mesh."""
    try:
        tr = MPTransport(rank, n, conns)
        parent.send(
            ("ok",) + _rank_levels(rank, n, tr, payload, starts, energy,
                                   opts)
        )
    except Exception as e:  # surface the rank's failure to the parent
        import traceback

        parent.send(("err", f"rank {rank}: {e}\n{traceback.format_exc()}"))
    finally:
        parent.close()


def _collective_rank(mesh, parts, starts, energy, opts):
    """One rank of a ``torch.distributed`` world: the level loop over a
    :class:`~.transport.CollectiveTransport`; rank 0 returns every rank's
    result (collected as pickled objects, not through the transport)."""
    import torch.distributed as dist

    from .transport import CollectiveTransport

    tr = CollectiveTransport(mesh)
    res = _rank_levels(mesh.rank, mesh.size, tr, parts[mesh.rank], starts,
                       energy, opts)
    got = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(res, got, dst=0)
    return got


def _device_tensors(obj, seen=None):
    """Names of the torch tensors off the CPU inside ``obj``'s attributes
    (dicts, lists and tuples walked)."""
    import torch

    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [] if obj.device.type == "cpu" else [str(obj.device)]
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return []
    return [d for v in items for d in _device_tensors(v, seen)]


def _mp_spawn_collect(parts, starts, energy, opts, n_ranks, timeout,
                      transport="pipes", backend=None, device=None):
    """Spawn one worker per rank, collect per-rank results: a pipe mesh of
    numpy ranks, or (``transport="collective"``) a ``torch.distributed``
    world of ``backend`` whose exchanges run on ``device``."""
    import multiprocessing as mp

    if transport == "collective":
        if backend is None or device is None:
            raise ValueError(
                "transport='collective' needs an explicit backend "
                "('gloo' or 'nccl') and device (e.g. 'cuda:0' or 'cpu')"
            )
        from .world import spawn_world

        return spawn_world(
            _collective_rank, n_ranks, backend=backend, device=device,
            args=(parts, starts, energy, opts), timeout=timeout,
        )
    if transport != "pipes":
        raise ValueError(f"unknown transport {transport!r}")
    on_device = _device_tensors(energy)
    if on_device:
        # the ranks cannot see a card; the energy must be host data
        raise ValueError(
            f"energy holds tensors on {sorted(set(on_device))}: the MP "
            "ranks take host data only"
        )
    ctx = mp.get_context("spawn")
    # pipe mesh: one duplex pipe per unordered rank pair + parent links
    pair = {}
    for i in range(n_ranks):
        for j in range(i + 1, n_ranks):
            a, b = ctx.Pipe(duplex=True)
            pair[(i, j)] = a
            pair[(j, i)] = b
    parent_conns, procs = [], []
    # the ranks are numpy processes: hide the card so that none of them
    # creates a CUDA context (spawned children inherit this environment)
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        for r in range(n_ranks):
            conns = {o: pair[(r, o)] for o in range(n_ranks) if o != r}
            pc, cc = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_mp_worker,
                args=(r, n_ranks, conns, cc, parts[r], starts, energy,
                      opts),
                daemon=True,
            )
            p.start()
            cc.close()
            parent_conns.append(pc)
            procs.append(p)
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved

    results = [None] * n_ranks
    try:
        for r, pc in enumerate(parent_conns):
            if not pc.poll(timeout):
                raise TimeoutError(f"rank {r} produced no result")
            msg = pc.recv()
            if msg[0] != "ok":
                raise RuntimeError(msg[1])
            results[r] = msg[1:]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results


def mp_dist_stokes_levels(
    A: sp.spmatrix,
    mesh0,
    bs: int,
    opts,
    n_ranks: int,
    timeout: float = 600.0,
    *,
    transport: str = "pipes",
    backend: str | None = None,
    device: str | None = None,
):
    """Stokes dual-mesh distributed setup across ``n_ranks`` OS
    processes: each rank receives ONLY its cell/facet slices of the dual
    mesh + its facet-DOF matrix rows and runs the rank-local
    `dist_stokes._stokes_levels_parts` under an :class:`MPTransport`.
    Returns the same `StokesLevel` list as `dist_stokes_levels`, plus
    the per-rank log.
    """
    from .dist_stokes import _split, package_stokes_levels

    A = A.tocsr().astype(np.float64)
    v_starts = _split(mesh0.nv, n_ranks)
    e_starts = _split(mesh0.ne, n_ranks)
    pos = mesh0.vertex_data["pos"]
    vol = mesh0.vertex_data["vol"]
    flow = mesh0.edge_data["flow"]
    parts = [
        {
            "stokes": (
                pos[v_starts[s]: v_starts[s + 1]],
                vol[v_starts[s]: v_starts[s + 1]],
                mesh0.edges[e_starts[s]: e_starts[s + 1]],
                flow[e_starts[s]: e_starts[s + 1]],
                A[e_starts[s] * bs: e_starts[s + 1] * bs],
                bs,
            )
        }
        for s in range(n_ranks)
    ]
    results = _mp_spawn_collect(
        parts, (v_starts, e_starts), None, opts, n_ranks, timeout,
        transport, backend, device,
    )
    from ..factory.levels import FactoryLog

    log = FactoryLog()
    stats0 = results[0][1]
    log.nvs = list(stats0["nvs"])
    log.nnzs = list(stats0["nnzs"])
    log.finest_global_bytes = stats0["finest_global_bytes"]
    log.peak_shard_bytes = max(
        res[1]["peak_shard_bytes"] for res in results
    )
    log.mp_rank_stats = [res[1] for res in results]
    n_levels = len(results[0][0])
    recs = []
    for li in range(n_levels):
        rr = [results[r][0][li] for r in range(n_ranks)]
        recs.append(
            {
                "v_starts": rr[0]["v_starts"],
                "e_starts": rr[0]["e_starts"],
                "A_parts": [rec["A"] for rec in rr],
                "pos_parts": [rec["pos"] for rec in rr],
                "vol_parts": [rec["vol"] for rec in rr],
                "edges_parts": [rec["edges"] for rec in rr],
                "flow_parts": [rec["flow"] for rec in rr],
                "C_parts": (
                    None
                    if rr[0]["C"] is None
                    else [rec["C"] for rec in rr]
                ),
                "P_parts": (
                    None
                    if rr[0]["P"] is None
                    else [rec["P"] for rec in rr]
                ),
                "v2agg_parts": (
                    None
                    if rr[0]["v2agg"] is None
                    else [rec["v2agg"] for rec in rr]
                ),
            }
        )
    return package_stokes_levels(recs), log


def mp_dist_stokes_hdiv_levels(
    A: sp.spmatrix,
    mesh0,
    dofs0,
    pres0,
    opts,
    n_ranks: int,
    timeout: float = 600.0,
    *,
    transport: str = "pipes",
    backend: str | None = None,
    device: str | None = None,
):
    """HDiv Stokes distributed setup across ``n_ranks`` OS processes
    (variable facet DOFs + preserved vectors, rank-local
    `dist_stokes._stokes_hdiv_levels_parts`)."""
    from .dist_stokes import _shard_hdiv_level0, package_hdiv_levels

    sd, cnt_parts, V_parts = _shard_hdiv_level0(
        A, mesh0, dofs0, pres0, n_ranks
    )
    parts = [
        {
            "stokes_hdiv": (
                sd.pos_parts[s], sd.vol_parts[s], sd.edges_parts[s],
                sd.flow_parts[s], sd.A_parts[s], cnt_parts[s],
                V_parts[s], pres0.n_special,
            )
        }
        for s in range(n_ranks)
    ]
    results = _mp_spawn_collect(
        parts, (sd.v_starts, sd.e_starts), None, opts, n_ranks, timeout,
        transport, backend, device,
    )
    from ..factory.levels import FactoryLog

    log = FactoryLog()
    stats0 = results[0][1]
    log.nvs = list(stats0["nvs"])
    log.nnzs = list(stats0["nnzs"])
    log.finest_global_bytes = stats0["finest_global_bytes"]
    log.peak_shard_bytes = max(
        res[1]["peak_shard_bytes"] for res in results
    )
    log.mp_rank_stats = [res[1] for res in results]
    n_levels = len(results[0][0])
    recs = []
    for li in range(n_levels):
        rr = [results[r][0][li] for r in range(n_ranks)]
        recs.append(
            {
                "v_starts": rr[0]["v_starts"],
                "e_starts": rr[0]["e_starts"],
                "A_parts": [rec["A"] for rec in rr],
                "pos_parts": [rec["pos"] for rec in rr],
                "vol_parts": [rec["vol"] for rec in rr],
                "edges_parts": [rec["edges"] for rec in rr],
                "flow_parts": [rec["flow"] for rec in rr],
                "cnt_parts": [rec["cnt"] for rec in rr],
                "V_parts": [rec["V"] for rec in rr],
                "P_parts": (
                    None
                    if rr[0]["P"] is None
                    else [rec["P"] for rec in rr]
                ),
                "v2agg_parts": (
                    None
                    if rr[0]["v2agg"] is None
                    else [rec["v2agg"] for rec in rr]
                ),
            }
        )
    return package_hdiv_levels(recs, pres0.n_special), log


def mp_dist_setup_levels(
    A: sp.spmatrix,
    energy,
    opts,
    n_ranks: int,
    timeout: float = 600.0,
    coords: np.ndarray | None = None,
    *,
    transport: str = "pipes",
    backend: str | None = None,
    device: str | None = None,
):
    """Distributed setup across ``n_ranks`` OS processes (scalar H1 and
    elasticity — the same uniformity as the reference's EQC/ReduceTable
    machinery driving every energy, reducetable.hpp:22-949).

    Each worker receives ONLY its contiguous row slice (+ its vertex
    positions for block energies; spawn start method: separate
    interpreters, no inherited address space) and runs the energy's
    rank-local level loop (`dist_setup._scalar_levels_parts` /
    `dist_elast._elast_levels_parts`) under an :class:`MPTransport`. The
    parent assembles the per-rank results into the same ``(levels, log)``
    as `dist_setup.dist_setup_levels` and attaches per-rank transport
    statistics at ``log.mp_rank_stats``. ``transport="collective"`` runs
    the ranks as a ``torch.distributed`` world of ``backend`` exchanging
    through ``CollectiveTransport`` on ``device`` (every rank receives the
    payload list and keeps its own).
    """
    from ..apps.elasticity import ElasticityEnergy
    from ..factory.levels import FactoryLog, SetupLevel
    from ..mesh.topo import AlgebraicMesh
    from .dist_setup import split_rows

    is_elast = isinstance(energy, ElasticityEnergy)
    A = A.tocsr().astype(np.float64)
    if is_elast:
        if coords is None:
            raise ValueError("elasticity needs vertex coordinates")
        dim, dpv = energy.dim, energy.dpv
        nv = A.shape[0] // dim
        starts = np.linspace(0, nv, n_ranks + 1).astype(np.int64)
        coords = np.asarray(coords, float)
        parts = [
            (
                A[starts[s] * dim : starts[s + 1] * dim],
                np.asarray(
                    coords[starts[s] : starts[s + 1]], dtype=np.float64
                ),
            )
            for s in range(n_ranks)
        ]
    else:
        bs = int(getattr(energy, "dpv", 1) or 1)
        if bs > 1:  # vector H1: vertex-aligned block-row split
            nv = A.shape[0] // bs
            vst = np.linspace(0, nv, n_ranks + 1).astype(np.int64)
            starts = vst * bs
            parts = [
                A[starts[s] : starts[s + 1]] for s in range(n_ranks)
            ]
        else:
            parts, starts = split_rows(A, n_ranks)

    results = _mp_spawn_collect(parts, starts, energy, opts, n_ranks,
                                timeout, transport, backend, device)

    def ph_mesh(n):
        return AlgebraicMesh(nv=n, edges=np.zeros((0, 2), dtype=np.int64))

    log = FactoryLog()
    stats0 = results[0][1]
    log.nvs = list(stats0["nvs"])
    log.nnzs = list(stats0["nnzs"])
    log.finest_global_bytes = stats0["finest_global_bytes"]
    log.contract_decisions = list(stats0.get("contract_decisions", []))
    log.shards_per_level = list(stats0.get("shards_per_level", []))
    log.peak_shard_bytes = max(
        res[1]["peak_shard_bytes"] for res in results
    )
    log.mp_rank_stats = [res[1] for res in results]

    n_levels = len(results[0][0])
    if is_elast:
        from .dist_elast import package_elast_levels

        recs = []
        for li in range(n_levels):
            rr = [results[r][0][li] for r in range(n_ranks)]
            recs.append(
                {
                    "P_parts": [rec["P"] for rec in rr],
                    "P_amg_parts": (
                        None
                        if rr[0]["P_amg"] is None
                        else [rec["P_amg"] for rec in rr]
                    ),
                    "v2agg_parts": [rec["v2agg"] for rec in rr],
                    "Ac_parts": [rec["Ac"] for rec in rr],
                    "coarse_starts": rr[0]["coarse_starts"],
                    "c_vst": rr[0]["c_vst"],
                    "row_bs_f": rr[0]["row_bs_f"],
                    "cpos_parts": [rec["cpos"] for rec in rr],
                    "cl2_parts": [rec["cl2"] for rec in rr],
                }
            )
        finest = {
            "pos_parts": [res[2]["pos"] for res in results],
            "l2_parts": [res[2]["l2"] for res in results],
        }
        return (
            package_elast_levels(A, recs, finest, dim, dpv, nv),
            log,
        )

    levels = [
        SetupLevel(
            index=0,
            A=sp.vstack(parts, format="csr"),
            row_bs=bs,
            mesh=ph_mesh(int(starts[-1]) // bs),
        )
    ]
    for li in range(n_levels):
        recs = [results[r][0][li] for r in range(n_ranks)]
        cs = recs[0]["coarse_starts"]
        levels[-1].P = sp.vstack(
            [rec["P"] for rec in recs], format="csr"
        ).tobsr(blocksize=(bs, bs))
        levels[-1].v2agg = np.concatenate([rec["v2agg"] for rec in recs])
        levels.append(
            SetupLevel(
                index=li + 1,
                A=sp.vstack([rec["Ac"] for rec in recs], format="csr"),
                row_bs=bs,
                mesh=ph_mesh(int(cs[-1]) // bs),
            )
        )
    return levels, log
