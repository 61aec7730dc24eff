"""Halo-exchange matvecs over a world of ranks.

Port of ngsamg_tpu/parallel/halo.py. The reference splits each parallel
matrix into owned and ghost couplings and overlaps its work with the halo
exchange (hybrid_matrix.hpp:28-144, dcc_map.hpp:20-134,
hybrid_base_smoother.hpp:56-61); the JAX package writes that as
``shard_map`` programs over a device mesh. Here each rank is a process of
the sharded solve (parallel/shard.py) holding its row block, and the
exchanges are ``torch.distributed`` collectives over the level's sub-group:

* :func:`dia_halo_matvec`: a row-sharded DIA matrix needs only the
  neighbours' edge values, ``lo`` rows left and ``hi`` rows right. The
  JAX package moves them with two ``ppermute`` shifts; gloo cannot send
  between ranks that share a card (``PERF.md``), so each rank all-gathers
  its two edges and picks its neighbours'. The rank's rows then run K2 on
  their window of the halo-extended x.
* :func:`plan_tile_halo` and :func:`_ghost_split` (host planners, copied):
  the owner/ghost split of a row-sharded tile-ELL or block-ELL level.
  :class:`HaloTileELL` and :class:`HaloBlockELL` apply the interior part M
  while the interface buffer is all-gathered (the collective is started
  first, asynchronously), then the ghost correction G from the buffer:
  O(interface) values a matvec, not the O(n) all-gather of x.
* :func:`tile_halo_matvec`: the one-shot tile-ELL form (buffer appended to
  x, one gather).
* :func:`demo_sharded_solve`: halo DIA matvec against scipy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..sparse.bell import rows_product
from ..sparse.formats import DiaWindow, matvec
from .shard import COUNTS, Placement, placement
from .world import Mesh


def _all_gather(buf: torch.Tensor, pl: Placement, async_op=False):
    out = buf.new_empty((pl.j * buf.shape[0],) + tuple(buf.shape[1:]))
    work = dist.all_gather_into_tensor(
        out, buf.contiguous(), group=pl.group, async_op=async_op
    )
    COUNTS["all_gather"] += 1
    COUNTS["bytes"] += out.numel() * out.element_size()
    return out, work


def dia_halo_matvec(A, mesh: Mesh, pl: Placement | None = None):
    """A matvec for a row-sharded DiaMatrix: ``fn(data_local, x_local)``
    gives the rank's rows of ``A @ x`` (``data_local`` its columns
    [r0, r0 + local) of ``A.data``, full storage; ``x_local`` its rows).
    Requires the halo (the largest |offset|) not to exceed one shard."""
    if pl is None:
        pl = placement(mesh, A.nrows_pad, mesh.size)
    if A.sym_half:
        raise ValueError("dia_halo_matvec: full storage only")
    local = pl.local
    lo = max(0, -min(A.offsets))
    hi = max(0, max(A.offsets))
    if max(lo, hi) > local:
        raise ValueError("halo wider than one shard; replicate this level")
    offsets = tuple(int(o) for o in A.offsets)
    windows: dict = {}

    def fn(data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        key = (data.data_ptr(), data.device)
        W = windows.get(key)
        if W is None:
            W = windows[key] = DiaWindow(
                data=data.contiguous(), offsets=offsets, nrows=local,
                x_len=lo + local + hi, x_base=lo,
            )
        # each rank's tail (lo values) and head (hi values), gathered; the
        # left neighbour's tail and the right one's head are the halo
        edges = torch.cat([x[local - lo:], x[:hi]])
        got, _ = _all_gather(edges, pl)
        got = got.reshape(pl.j, lo + hi, x.shape[1])
        s = pl.index
        tail = got[s - 1, :lo] if s > 0 else x.new_zeros((lo, x.shape[1]))
        head = (got[s + 1, lo:] if s < pl.j - 1
                else x.new_zeros((hi, x.shape[1])))
        return matvec(W, torch.cat([tail, x, head]))

    return fn


def demo_sharded_solve(mesh: Mesh, n: int = 24) -> float:
    """End-to-end check on every rank of ``mesh``: the halo-exchange DIA
    matvec equals the scipy product (relative max error, same on every
    rank)."""
    from ..sparse import formats
    from ..utils import fem

    p = fem.poisson_3d(n)
    A = formats.dia_from_scipy(p.A, np.float32, row_align=8 * mesh.size)
    pl = placement(mesh, A.nrows_pad, mesh.size)
    x = np.random.default_rng(0).standard_normal(A.nrows_pad)
    xs = torch.as_tensor(x[:, None], dtype=torch.float32)
    sl = slice(pl.r0, pl.r0 + pl.local)
    fn = dia_halo_matvec(A, mesh, pl)
    y = fn(A.data[:, sl].to(mesh.device), xs[sl].to(mesh.device))
    y = pl.gather(y).cpu().numpy()[:, 0]
    ref = p.A @ x[: p.n]
    return float(np.abs(y[: p.n] - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# interface-halo SpMV for unstructured (tile-ELL, block-ELL) levels
# ---------------------------------------------------------------------------


def plan_tile_halo(cols: np.ndarray, nrows_pad: int, n_shards: int):
    """Owner/ghost split of a row-sharded TileELL's columns (host).

    Copied from ngsamg_tpu/parallel/halo.py. The DCC-map analog
    (dcc_map.hpp:20-134) for unstructured levels: each shard owns a
    contiguous row block; columns outside it are GHOSTS. Every shard
    contributes its interface rows (the union of all other shards' ghost
    needs) to one padded all-gather buffer — communication is O(total
    interface), not O(n) as under the all-gather of x.

    Returns (new_cols (T, K) int32 into [local_n + nsh*Smax),
             send_idx (n_shards, Smax) int32 LOCAL row indices, Smax).
    """
    T, K = cols.shape
    assert nrows_pad % n_shards == 0 and T % n_shards == 0
    local = nrows_pad // n_shards
    Tl = T // n_shards
    owner = (cols // local).astype(np.int64)
    # single sort/unique pass over (owner, col) pairs: ghost entries are
    # slots whose column's owner differs from the reading shard
    reader = np.repeat(
        np.arange(T, dtype=np.int64) // Tl, K
    )
    flat_c = cols.ravel().astype(np.int64)
    flat_o = owner.ravel()
    gh_flat = flat_o != reader
    keys = np.unique(flat_o[gh_flat] * np.int64(nrows_pad) + flat_c[gh_flat])
    key_owner = keys // nrows_pad
    key_col = keys % nrows_pad
    counts = np.bincount(key_owner, minlength=n_shards)
    starts = np.concatenate([[0], np.cumsum(counts)])
    Smax = max(int(counts.max(initial=0)), 1)
    send_idx = np.zeros((n_shards, Smax), dtype=np.int32)
    for t in range(n_shards):
        lst = key_col[starts[t]:starts[t + 1]]
        send_idx[t, : len(lst)] = (lst - t * local).astype(np.int32)
    # remap columns: local -> [0, local); ghost g owned by t at position
    # p within owner t's (sorted) send list -> local + t*Smax + p
    new_cols = (flat_c - flat_o * local).astype(np.int64)
    if gh_flat.any():
        pos = np.searchsorted(keys, flat_o[gh_flat] * np.int64(nrows_pad)
                              + flat_c[gh_flat])
        new_cols[gh_flat] = (
            local + flat_o[gh_flat] * Smax + (pos - starts[flat_o[gh_flat]])
        )
    return (
        new_cols.reshape(T, K).astype(np.int32), send_idx, int(Smax)
    )


def _ghost_split(new_cols, data, send_shape_local, nsh, Tl, local):
    """Extract the G (ghost) part per shard: per ghost slot its local
    tile, its data row(s), and its gathered-buffer index; zero the slot
    out of the interior arrays. Returns (cols_own, data_own,
    gtile (nsh, gmax), gdata (nsh, gmax, ...), gcol (nsh, gmax)).

    Copied from ngsamg_tpu/parallel/halo.py."""
    T, K = new_cols.shape
    gh = new_cols >= local
    counts = [int(gh[s * Tl:(s + 1) * Tl].sum()) for s in range(nsh)]
    gmax = max(max(counts), 1)
    tail = data.shape[2:]
    gtile = np.zeros((nsh, gmax), dtype=np.int32)
    gdata = np.zeros((nsh, gmax) + tail, dtype=data.dtype)
    gcol = np.zeros((nsh, gmax), dtype=np.int32)
    data_own = data.copy()
    cols_own = new_cols.copy()
    for s in range(nsh):
        sl = slice(s * Tl, (s + 1) * Tl)
        t, k = np.nonzero(gh[sl])
        m = len(t)
        gtile[s, :m] = t.astype(np.int32)
        gdata[s, :m] = data[sl][t, k]
        gcol[s, :m] = (new_cols[sl][t, k] - local).astype(np.int32)
        data_own[sl][t, k] = 0
        cols_own[sl][t, k] = 0
    return cols_own, data_own, gtile, gdata, gcol, gmax


@dataclass(frozen=True, eq=False)
class HaloTileELL:
    """The rank's rows of a row-sharded TileELL whose matvec exchanges
    INTERFACE values only: the M+G split of the reference's hybrid matrix.
    ``data``/``cols`` hold the interior part M (ghost slots zeroed,
    columns all local), applied while the interface buffer (each shard's
    ``smax`` values) is all-gathered; the G part is a per-ghost-slot
    correction from the buffer. Built by ``shard_operator`` for fully
    row-sharded TileELL levels."""

    data: torch.Tensor  # (Tl, K, M) interior part, ghost slots zeroed
    cols: torch.Tensor  # (Tl, K) int64, all < local (ghost slots -> 0)
    send: torch.Tensor  # (smax,) int64 local rows this rank contributes
    gtile: torch.Tensor  # (gmax,) int64 local tile of each ghost slot
    gdata: torch.Tensor  # (gmax, M) ghost-slot matrix data
    gcol: torch.Tensor  # (gmax,) int64 index into the gathered buffer
    pl: Placement
    nrows: int
    nrows_pad: int  # of the whole level
    ncols_pad: int
    tile_m: int
    smax: int
    nsh: int
    gmax: int

    @property
    def placement(self) -> Placement:
        return self.pl

    @property
    def shape(self):
        return self.nrows, self.ncols_pad

    @property
    def comm_per_apply(self) -> int:
        """Gathered scalars per matvec (the O(interface) volume)."""
        return self.nsh * self.smax

    def halo_matvec(self, x: torch.Tensor) -> torch.Tensor:
        xf = x[:, 0]
        # start the collective FIRST; the interior product has no data
        # dependence on it
        buf, work = _all_gather(xf[self.send], self.pl, async_op=True)
        T, K = self.cols.shape
        y = torch.bmm(
            xf[self.cols].reshape(T, 1, K), self.data
        ).reshape(T, self.tile_m)
        work.wait()
        contrib = self.gdata * buf[self.gcol][:, None]  # (gmax, M)
        y = y.index_add(0, self.gtile, contrib)
        return y.reshape(-1, 1)

    def apply_full(self, x_full: torch.Tensor) -> torch.Tensor:
        return self.halo_matvec(self.pl.take(x_full))


@dataclass(frozen=True, eq=False)
class HaloBlockELL:
    """The rank's block rows of a row-sharded BlockELL with INTERFACE-ONLY
    exchange: the block-format hybrid matrix. ``cols`` are remapped to
    [0, local) for owned block columns (ghost slots zeroed out of the
    interior); ``send`` lists the interface block rows the rank
    contributes to one padded all-gather of (smax, bc) slabs."""

    data: torch.Tensor  # (nl, K, br, bc) interior part, ghost slots zeroed
    cols: torch.Tensor  # (nl, K) int64, all < local (ghost slots -> 0)
    send: torch.Tensor  # (smax,) int64 local block rows
    gtile: torch.Tensor  # (gmax,) int64 local block row per ghost slot
    gdata: torch.Tensor  # (gmax, br, bc) ghost-slot blocks
    gcol: torch.Tensor  # (gmax,) int64 index into the gathered buffer
    pl: Placement
    nrows: int  # logical block rows of the whole level
    nrows_pad: int
    ncols_pad: int
    block_shape: tuple
    col_chunk: int
    smax: int
    nsh: int
    gmax: int

    @property
    def placement(self) -> Placement:
        return self.pl

    @property
    def shape(self) -> tuple[int, int]:
        br, bc = self.block_shape
        return self.nrows * br, self.ncols_pad * bc

    @property
    def comm_per_apply(self) -> int:
        """Gathered scalars per matvec (the O(interface) volume)."""
        return self.nsh * self.smax * self.block_shape[1]

    def halo_matvec(self, x: torch.Tensor) -> torch.Tensor:
        # collective first; the interior product is independent
        buf, work = _all_gather(x[self.send], self.pl, async_op=True)
        y = rows_product(self.data, x[self.cols])
        work.wait()
        contrib = torch.einsum("gij,gj->gi", self.gdata, buf[self.gcol])
        return y.index_add(0, self.gtile, contrib)

    def apply_full(self, x_full: torch.Tensor) -> torch.Tensor:
        return self.halo_matvec(self.pl.take(x_full))


def _rank_split(cols, data, nrows_pad, pl, dev):
    """This rank's interior and ghost arrays of a row-sharded tile-ELL
    (tiles of ``nrows_pad / T`` rows) or square block-ELL (one block row a
    "tile") level, on ``dev``."""
    nsh = pl.j
    Tl = cols.shape[0] // nsh
    new_cols, send_idx, smax = plan_tile_halo(cols, nrows_pad, nsh)
    cols_own, data_own, gtile, gdata, gcol, gmax = _ghost_split(
        new_cols, data, None, nsh, Tl, nrows_pad // nsh
    )
    s = pl.index
    sl = slice(s * Tl, (s + 1) * Tl)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=dev, dtype=dtype
        )

    return dict(
        data=t(data_own[sl]),
        cols=t(cols_own[sl], torch.int64),
        send=t(send_idx[s], torch.int64),
        gtile=t(gtile[s], torch.int64),
        gdata=t(gdata[s]),
        gcol=t(gcol[s], torch.int64),
    ), smax, gmax


def halo_block_ell(A, mesh: Mesh, pl: Placement) -> HaloBlockELL:
    """This rank's :class:`HaloBlockELL` from a (host-readable) BlockELL.

    Reuses :func:`plan_tile_halo` in BLOCK space: the column index space
    of a square BlockELL is its block-row space, so the owner/ghost split
    and send lists apply unchanged with "tile" = block row.
    """
    if A.col_chunk != 1:
        raise ValueError("halo_block_ell requires col_chunk == 1")
    cols = A.cols.cpu().numpy()
    n_pad = cols.shape[0]
    arrays, smax, gmax = _rank_split(
        cols, A.data.cpu().numpy(), n_pad, pl, mesh.device
    )
    return HaloBlockELL(
        **arrays,
        pl=pl,
        nrows=A.nrows,
        nrows_pad=n_pad,
        ncols_pad=n_pad,  # square sharded levels: x pads like the rows
        block_shape=A.block_shape,
        col_chunk=1,
        smax=smax,
        nsh=pl.j,
        gmax=gmax,
    )


def halo_tile_ell(A, mesh: Mesh, pl: Placement) -> HaloTileELL:
    """This rank's :class:`HaloTileELL` from a (host-readable) TileELL
    (the one-time plan reads ``A.cols`` on the host)."""
    if A.chunk_c != 1:
        raise ValueError("halo_tile_ell requires chunk_c == 1")
    cols = A.cols.cpu().numpy()
    arrays, smax, gmax = _rank_split(
        cols, A.data.cpu().numpy(), A.nrows_pad, pl, mesh.device
    )
    return HaloTileELL(
        **arrays,
        pl=pl,
        nrows=A.nrows,
        nrows_pad=A.nrows_pad,
        ncols_pad=A.ncols_pad,
        tile_m=A.tile_m,
        smax=smax,
        nsh=pl.j,
        gmax=gmax,
    )


def tile_halo_matvec(A, mesh: Mesh, pl: Placement | None = None):
    """A TileELL matvec with interface-only exchange.

    Returns ``(fn, data_local, cols_local, send_local, comm_per_apply)``
    where ``fn(data, cols, send, x_local)`` gives the rank's rows, and
    ``comm_per_apply`` is the gathered element count (n_shards * Smax).
    """
    if pl is None:
        pl = placement(mesh, A.nrows_pad, mesh.size)
    nsh = pl.j
    cols = A.cols.cpu().numpy()
    new_cols, send_idx, smax = plan_tile_halo(cols, A.nrows_pad, nsh)
    T = cols.shape[0]
    Tl = T // nsh
    sl = slice(pl.index * Tl, (pl.index + 1) * Tl)
    dev = mesh.device

    def fn(data, cols_l, send_l, x):
        xf = x[:, 0]
        buf, _ = _all_gather(xf[send_l], pl)
        xp = torch.cat([xf, buf])
        t, k = cols_l.shape
        y = torch.bmm(xp[cols_l].reshape(t, 1, k), data)
        return y.reshape(-1, 1)

    return (
        fn,
        A.data[sl].to(dev),
        torch.from_numpy(new_cols[sl].astype(np.int64)).to(dev),
        torch.from_numpy(send_idx[pl.index].astype(np.int64)).to(dev),
        nsh * smax,
    )
