"""Row sharding of the AMG hierarchy over a world of ranks.

Port of ngsamg_tpu/parallel/shard.py. The JAX package is single-
controller: one process holds a ``Mesh`` of devices, places each level's
arrays with sharding annotations and lets GSPMD insert the collectives.
This port follows PyTorch's idiom instead, SPMD with one process per rank
on ``torch.distributed`` (parallel/world.py):

* each rank holds only its row block of a sharded level, and a full copy
  of a replicated level;
* each rank runs the same cycle, smoother and PCG code of the single-
  device path on plain tensors (solve/cycle.py, smoothers/core.py,
  solve/pcg.py): the sharded objects apply themselves through the
  methods every operator, smoother and cluster correction has
  (``matvec``, ``sweep``, ``apply``), and the Krylov reductions and the
  coarse solve read a level's ``placement``;
* collectives appear only in the sharded formats' matvecs, in the
  transfers between placements, and in the Krylov reductions.

The placement decisions are the JAX package's: fine levels row-sharded
over every rank, mid-size levels over 2^k-rank sub-groups (replicated
across the rest: the ``GridContractMap`` analog), coarse levels
replicated; the hierarchy's own contraction decisions (``shards_hint``)
cap a level's count; partially replicated levels keep a replicated P, and
R is always replicated.

Where a JAX level relies on GSPMD's all-gather of x (every sharded level
without a halo structure), the port's level all-gathers x over its sub-
group and computes its own rows (:class:`RowShard`). A DIA level's rows
run K2 on their window (ops/dia_cuda.py ``dia_matvec`` of a ``DiaWindow``)
over the gathered x; a symmetric-half level is expanded to full storage for its
rows when it is placed (the mirrored diagonals ``A[i, i-o] = data[o][i-o]``
come from the rows left of the block, read once, here). A ``StencilDia``
keeps its replicated values: its rank applies K1 to the gathered x and
keeps its rows. Fully sharded tile-ELL levels, and block-ELL levels under
Jacobi or Chebyshev, take the interface-halo formats of
parallel/halo.py. Multicolor GS exchanges the updated rows after every
colour step (the global colouring makes a colour's rows independent
across shards; the next colour reads them); the block GS sweeps its
replicated blocks on the gathered vectors.

:data:`COUNTS` counts this rank's collective rounds and the bytes it
receives from them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..smoothers.block import BlockGSSmoother
from ..smoothers.build import _to_device
from ..smoothers.cluster_corr import ClusterCorrection
from ..smoothers.core import (
    ChebyshevSmoother,
    GSSmoother,
    JacobiSmoother,
    _block_mul,
)
from ..smoothers.hiptmair import HiptmairSmoother
from ..solve.cycle import AMGOperator, DeviceLevel
from ..sparse.bell import BlockELL, rows_product
from ..sparse.formats import (
    DenseMatrix,
    DiaMatrix,
    DiaWindow,
    StencilDia,
    TileELL,
    TileELLStack,
    matvec,
)
from ..transfer.lattice_transfer import (
    LatticeProlongation,
    LatticeRestriction,
    _downsample_sum,
    _upsample,
)
from .world import Mesh, make_mesh, spawn_world

__all__ = [
    "COUNTS",
    "Mesh",
    "Placement",
    "RowShard",
    "make_mesh",
    "spawn_world",
    "shard_operator",
    "level_shard_counts",
    "local_rows",
    "gather_rows",
]

# this rank's collective rounds by kind, and the bytes they brought in
COUNTS = {"all_gather": 0, "all_reduce": 0, "gs_rounds": 0, "bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass(frozen=True, eq=False)
class Placement:
    """Where one level's vectors live: ``n_pad`` rows cut into ``j``
    contiguous shards; this rank holds shard ``index`` (all rows when
    ``j == 1``). ``owner`` marks the ranks of replica 0, the ones whose
    rows a reduction counts."""

    n_pad: int
    j: int
    index: int
    owner: bool
    group: object = None

    @property
    def local(self) -> int:
        return self.n_pad // self.j

    @property
    def r0(self) -> int:
        return self.index * self.local

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full vector from every shard's rows (identity if j == 1)."""
        if self.j == 1:
            return x
        out = x.new_empty((self.n_pad,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        COUNTS["all_gather"] += 1
        COUNTS["bytes"] += out.numel() * out.element_size()
        return out

    def take(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full vector."""
        if self.j == 1:
            return y
        return y[self.r0: self.r0 + self.local]

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """<a, b> over the rows of one replica (each row counted once),
        the same value on every rank (the sharded PCG's reductions)."""
        part = torch.dot(a.reshape(-1), b.reshape(-1)).reshape(1)
        if not self.owner:
            part = torch.zeros_like(part)
        dist.all_reduce(part)
        COUNTS["all_reduce"] += 1
        COUNTS["bytes"] += part.element_size()
        return part[0]


def placement(mesh: Mesh, n_pad: int, j: int) -> Placement:
    if j <= 1:
        return Placement(n_pad=n_pad, j=1, index=0, owner=mesh.rank == 0)
    return Placement(
        n_pad=n_pad,
        j=j,
        index=mesh.shard_index(j),
        owner=mesh.replica_index(j) == 0,
        group=mesh.group(j),
    )


# ---------------------------------------------------------------------------
# sharded operators
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class RowShard:
    """A sharded level operator or transfer in the GSPMD style: x is
    all-gathered over ``src``'s sub-group, then ``A`` gives ``dst``'s rows:
    ``A`` holds only those rows (``local_rows``) or is the full, replicated
    operator whose product this rank cuts to its rows."""

    A: object
    src: Placement
    dst: Placement
    local_rows: bool

    @property
    def placement(self) -> Placement:
        return self.dst

    @property
    def nrows_pad(self) -> int:
        return self.dst.local

    def apply_full(self, x_full: torch.Tensor) -> torch.Tensor:
        y = matvec(self.A, x_full)
        return y if self.local_rows else self.dst.take(y)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_full(self.src.gather(x))


def _apply_full(A, x_full: torch.Tensor) -> torch.Tensor:
    """The rank's rows of ``A @ x`` from the whole x (any level format)."""
    f = getattr(A, "apply_full", None)
    return matvec(A, x_full) if f is None else f(x_full)


@dataclass(frozen=True, eq=False)
class ShardedLatticeProlongation:
    """x_f = (I - omega Dinv A) upsample(x_c) on the fine level's rows: the
    coarse vector is gathered and upsampled, the level's own sharded
    operator ``A`` gives the rank's rows of the smoothing term."""

    P: LatticeProlongation  # dims, omega, sizes (its A and Dinv unused)
    A: RowShard
    Dinv: torch.Tensor  # the rank's rows, or (1, 1)
    src: Placement
    dst: Placement

    @property
    def placement(self) -> Placement:
        return self.dst

    def matvec(self, xc: torch.Tensor) -> torch.Tensor:
        P = self.P
        xc = self.src.gather(xc)
        u = _upsample(xc[: P.nc, 0], P.dims_c, P.dims_f)
        u = torch.nn.functional.pad(u, (0, P.nf_pad - P.nf))[:, None]
        return self.dst.take(u) - P.omega * self.Dinv * _apply_full(
            self.A, u
        )


@dataclass(frozen=True, eq=False)
class ShardedLatticeRestriction:
    """x_c = downsample_sum((I - omega A Dinv) r_f): the rank's rows of the
    smoothing term through the level's sharded operator, then the fine
    vector gathered, summed down and cut to the coarse placement."""

    R: LatticeRestriction
    A: RowShard
    Dinv: torch.Tensor
    src: Placement
    dst: Placement

    @property
    def placement(self) -> Placement:
        return self.dst

    def matvec(self, rf: torch.Tensor) -> torch.Tensor:
        R = self.R
        w = rf - R.omega * matvec(self.A, self.Dinv * rf)
        w = self.src.gather(w)
        wc = _downsample_sum(w[: R.nf, 0], R.dims_f, R.dims_c)
        wc = torch.nn.functional.pad(wc, (0, R.nc_pad - R.nc))[:, None]
        return self.dst.take(wc)


def _dia_rows(A: DiaMatrix, r0: int, r1: int, dev) -> DiaWindow:
    """Rows [r0, r1) of a DIA matrix as a windowed full-storage block over
    the whole x. A symmetric-half level gets its mirrored diagonals:
    row i of offset -o is data[o][i - o] (zero for i < o)."""
    data = A.data
    if not A.sym_half:
        return DiaWindow(
            data=data[:, r0:r1].contiguous().to(dev),
            offsets=tuple(A.offsets),
            nrows=r1 - r0,
            x_len=A.nrows_pad,
            x_base=r0,
        )
    rows, offs = [], []
    for d in range(len(A.offsets) - 1, -1, -1):
        o = int(A.offsets[d])
        if o > 0:
            idx = torch.arange(r0 - o, r1 - o)
            vals = data[d][idx.clamp(min=0)]
            rows.append(torch.where(idx >= 0, vals, torch.zeros_like(vals)))
            offs.append(-o)
    for d, o in enumerate(A.offsets):
        rows.append(data[d, r0:r1])
        offs.append(int(o))
    return DiaWindow(
        data=torch.stack(rows).contiguous().to(dev),
        offsets=tuple(offs),
        nrows=r1 - r0,
        x_len=A.nrows_pad,
        x_base=r0,
    )


def _rows_of(A, pl: Placement, dev):
    """The rank's rows of ``A`` on ``dev``, reading a full x; None for the
    formats that stay whole (stencil, dense)."""
    r0, r1 = pl.r0, pl.r0 + pl.local
    nrows = max(0, min(A.nrows, r1) - r0)
    if isinstance(A, BlockELL):
        return BlockELL(
            data=A.data[r0:r1].to(dev),
            cols=A.cols[r0:r1].to(dev),
            nrows=nrows,
            ncols=A.ncols,
            nrows_pad=r1 - r0,
            col_chunk=A.col_chunk,
            nslots=None if A.nslots is None else A.nslots[r0:r1].to(dev),
        )
    if isinstance(A, TileELL):
        t0, t1 = r0 // A.tile_m, r1 // A.tile_m
        return TileELL(
            data=A.data[t0:t1].to(dev),
            cols=A.cols[t0:t1].to(dev),
            nrows=nrows,
            nrows_pad=r1 - r0,
            ncols_pad=A.ncols_pad,
            tile_m=A.tile_m,
            chunk_c=A.chunk_c,
        )
    if isinstance(A, DiaMatrix):
        return _dia_rows(A, r0, r1, dev)
    if isinstance(A, (StencilDia, DenseMatrix)):
        return None
    raise TypeError(type(A))


def _shard_mat(A, src: Placement, dst: Placement, dev, rows_sharded: bool):
    """Place a level operator or explicit transfer: ``dst``'s rows when
    ``rows_sharded``, else the whole operator (replicated), applied to x
    gathered over ``src``."""
    if isinstance(A, TileELLStack):
        raise TypeError(
            "TileELLStack levels are staged for one device only "
            "(AMGOptions(shards > 1) packs plain TileELL)"
        )
    if src.j == 1 and dst.j == 1:
        return _to_device(A, dev)
    part = _rows_of(A, dst, dev) if (rows_sharded and dst.j > 1) else None
    if part is None:
        return RowShard(A=_to_device(A, dev), src=src, dst=dst,
                        local_rows=False)
    return RowShard(A=part, src=src, dst=dst, local_rows=True)


def _dinv_rows(Dinv: torch.Tensor, pl: Placement, dev):
    # a broadcast-scalar Dinv (uniform stencil levels) replicates
    if Dinv.shape[0] == 1 or pl.j == 1:
        return Dinv.to(dev)
    return Dinv[pl.r0: pl.r0 + pl.local].to(dev)


# ---------------------------------------------------------------------------
# sharded smoothers
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class ShardedGS:
    """Multicolor GS on the rank's rows of a row-sharded block-ELL level
    (the colour-sorted rows, sliced). Each colour step updates the
    rank's rows of that colour from the gathered x, then all-gathers the
    colour's updated rows (padded to the largest shard's share) so the
    next colour reads them: one round a colour step, O(colour rows)."""

    Dinv: torch.Tensor  # (local, bs, bs)
    data: torch.Tensor  # the rank's rows of A (local, K, bs, bs)
    cols: torch.Tensor  # (local, K) int64 global block columns
    spans: tuple  # per colour: (lo, hi) local rows of the colour
    width: tuple  # per colour: rows a shard sends (0: the colour is empty)
    sel: tuple  # per colour: positions in the gathered buffer ...
    dst: tuple  # ... and the rows of the full x they update
    steps: int
    pl: Placement

    def sweep(self, A, x, b, *, reverse: bool):
        pl = self.pl
        zero_start = x is None
        x = torch.zeros_like(b) if zero_start else x.clone()
        xf = pl.gather(x)
        bs = b.shape[1]
        ncol = len(self.spans)
        order = list(range(ncol - 1, -1, -1) if reverse else range(ncol))
        steps = [(s, c) for s in range(self.steps) for c in order]
        for k, (step, c) in enumerate(steps):
            m = self.width[c]
            if m == 0:
                continue
            lo, hi = self.spans[c]
            if hi > lo:
                if zero_start and k == 0:
                    r = b[lo:hi]  # x == 0: skip the row product
                else:
                    cl = self.cols[lo:hi]
                    r = b[lo:hi] - rows_product(self.data[lo:hi], xf[cl])
                x[lo:hi] += _block_mul(self.Dinv[lo:hi], r)
            if k == len(steps) - 1:
                break  # the last step's rows are not read again
            buf = x.new_zeros((m, bs))
            buf[: hi - lo] = x[lo:hi]
            got = x.new_empty((pl.j * m, bs))
            dist.all_gather_into_tensor(got, buf, group=pl.group)
            COUNTS["all_gather"] += 1
            COUNTS["gs_rounds"] += 1
            COUNTS["bytes"] += got.numel() * got.element_size()
            xf[self.dst[c]] = got[self.sel[c]]
        return x


def _sharded_gs(sm: GSSmoother, A: BlockELL, pl: Placement, dev):
    # the sweep slices the level's own (colour-sorted) rows; a split
    # per-colour copy (single-device staging) is not carried over, as in
    # the JAX package
    bounds = sm.color_bounds
    r0, loc = pl.r0, pl.local
    spans, width, sel, dst = [], [], [], []
    for c in range(len(bounds) - 1):
        lo, hi = bounds[c], bounds[c + 1]
        per = [
            (max(lo, s * loc), min(hi, (s + 1) * loc))
            for s in range(pl.j)
        ]
        lens = [max(0, b - a) for a, b in per]
        m = max(lens)
        a, bnd = per[pl.index]
        spans.append((a - r0, max(a, bnd) - r0) if lens[pl.index] else (0, 0))
        width.append(m)
        s_idx = np.concatenate(
            [s * m + np.arange(n) for s, n in enumerate(lens)]
        ).astype(np.int64) if m else np.zeros(0, np.int64)
        d_idx = np.concatenate(
            [np.arange(a, a + n) for (a, _), n in zip(per, lens)]
        ).astype(np.int64) if m else np.zeros(0, np.int64)
        sel.append(torch.from_numpy(s_idx).to(dev))
        dst.append(torch.from_numpy(d_idx).to(dev))
    return ShardedGS(
        Dinv=_dinv_rows(sm.Dinv, pl, dev),
        data=A.data[r0: r0 + loc].to(dev),
        cols=A.cols[r0: r0 + loc].to(device=dev, dtype=torch.int64),
        spans=tuple(spans),
        width=tuple(width),
        sel=tuple(sel),
        dst=tuple(dst),
        steps=sm.steps,
        pl=pl,
    )


@dataclass(frozen=True, eq=False)
class ReplicatedSweep:
    """A smoother that sweeps rows of any shard (the block GS: its blocks
    are replicated, as in the JAX package): x and b are gathered, the
    sweep runs on the whole level, and the rank keeps its rows."""

    inner: object
    A: object  # the whole level operator, replicated
    pl: Placement

    def sweep(self, A, x, b, *, reverse: bool):
        xf = None if x is None else self.pl.gather(x)
        bf = self.pl.gather(b)
        return self.pl.take(
            self.inner.sweep(self.A, xf, bf, reverse=reverse))


def _shard_smoother(sm, A, pl: Placement, mesh: Mesh, dev):
    """``A`` is the level's whole operator (host or device tensors)."""
    if sm is None:
        return None
    if pl.j == 1:
        return _to_device(sm, dev)
    if isinstance(sm, JacobiSmoother):
        return JacobiSmoother(
            Dinv=_dinv_rows(sm.Dinv, pl, dev), omega=sm.omega,
            steps=sm.steps,
        )
    if isinstance(sm, ChebyshevSmoother):
        return ChebyshevSmoother(
            Dinv=_dinv_rows(sm.Dinv, pl, dev),
            lam_max=sm.lam_max,
            lam_min=sm.lam_min,
            order=sm.order,
            steps=sm.steps,
        )
    if isinstance(sm, BlockGSSmoother):
        # block sweeps read arbitrary rows; the (small) block data stays
        # replicated and the sweep runs on gathered vectors
        return ReplicatedSweep(
            inner=_to_device(sm, dev), A=_to_device(A, dev), pl=pl
        )
    if isinstance(sm, HiptmairSmoother):
        # two-space smoother: C's rows follow the level; the potential
        # space is sharded over the same ranks when its padded dimension
        # divides them, else replicated
        n_pot = sm.A_pot.nrows_pad
        pot = placement(mesh, n_pot, pl.j if n_pot % pl.j == 0 else 1)
        return HiptmairSmoother(
            range_sm=_shard_smoother(sm.range_sm, A, pl, mesh, dev),
            pot_sm=_shard_smoother(sm.pot_sm, sm.A_pot, pot, mesh, dev),
            A_pot=_shard_mat(sm.A_pot, pot, pot, dev, True),
            C=_shard_mat(sm.C, pot, pl, dev, True),
            CT=_shard_mat(sm.CT, pl, pot, dev, True),
        )
    if isinstance(sm, GSSmoother):
        # the global colouring makes a colour's rows independent across
        # shards; the exchange after each colour step feeds the next
        return _sharded_gs(sm, A, pl, dev)
    raise TypeError(type(sm))


@dataclass(frozen=True, eq=False)
class ShardedCluster:
    """The finest level's cluster correction on a sharded level: the
    residual is gathered, the (replicated) batched solves applied, and the
    rank keeps its rows."""

    cc: ClusterCorrection
    pl: Placement

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.pl.take(self.cc.apply(self.pl.gather(r)))


# ---------------------------------------------------------------------------
# placement of the hierarchy
# ---------------------------------------------------------------------------


def _lead(fmt) -> int:
    # size of the dimension the row sharding actually partitions
    if isinstance(fmt, (TileELL, BlockELL)):
        return fmt.data.shape[0]  # tiles / block rows
    if isinstance(fmt, TileELLStack):
        return fmt.nrows_pad // fmt.tile_m
    return fmt.nrows_pad


def _placements(op: AMGOperator, n: int, factored: bool, *,
                replicate_below, min_local_rows, shards_hint):
    """The JAX package's shard count per level."""

    def n_shards_for(fmt) -> int:
        if isinstance(fmt, DenseMatrix):
            return 1
        lead = _lead(fmt)
        if fmt.nrows >= replicate_below and lead % n == 0:
            return n
        if not factored:
            return 1
        j = n // 2
        while j > 1 and (lead % j != 0 or fmt.nrows // j < min_local_rows):
            j //= 2
        return max(j, 1)

    out = []
    for li, lev in enumerate(op.levels):
        j = n_shards_for(lev.A)
        # the level loop's OWN contraction decision (TryContractStep
        # analog, FactoryLog.shards_per_level) caps the placement
        if shards_hint is not None and li < len(shards_hint):
            k = 1
            while (k << 1) <= int(shards_hint[li]):
                k <<= 1
            j = min(j, k) if int(shards_hint[li]) > 0 else j
        if not factored and j not in (1, n):
            j = 1
        out.append(j)
    return out


def shard_operator(
    op: AMGOperator,
    A0,
    mesh: Mesh,
    *,
    replicate_below: int = 4096,
    min_local_rows: int = 512,
    shards_hint: tuple | list | None = None,
) -> tuple[AMGOperator, object]:
    """This rank's part of the hierarchy ``op`` (the whole hierarchy,
    host or device tensors; every rank calls this with the same one).

    Fine levels row-shard over every rank, mid-size levels over 2^k-rank
    sub-groups (the largest power of two that divides the level's lead
    dimension and keeps >= ``min_local_rows`` rows a shard), levels below
    ``replicate_below`` rows replicate, and ``shards_hint`` (the setup's
    ``FactoryLog.shards_per_level``) caps each level's count. Returns
    ``(op_s, A0_s)``: the rank's operator, on ``mesh.device``, and its
    finest level (the PCG operator; its ``placement`` cuts and reduces the
    Krylov vectors). ``A0`` is the finest operator of ``op`` (the JAX
    signature's second argument).
    """
    del A0  # the finest level of op; kept for the JAX signature
    n = mesh.size
    dev = mesh.device
    js = _placements(
        op, n, mesh.factored, replicate_below=replicate_below,
        min_local_rows=min_local_rows, shards_hint=shards_hint,
    )
    pls = [
        placement(mesh, lev.A.nrows_pad, j) for lev, j in zip(op.levels, js)
    ]
    new_A = []
    for li, lev in enumerate(op.levels):
        j, pl = js[li], pls[li]
        A = lev.A
        if j == n and j > 1 and isinstance(A, TileELL):
            # fully-row-sharded unstructured levels exchange INTERFACE
            # values only (the hybrid matrix's M+G split)
            from .halo import halo_tile_ell

            new_A.append(halo_tile_ell(A, mesh, pl))
        elif (
            j == n and j > 1
            and isinstance(A, BlockELL) and A.col_chunk == 1
            and isinstance(lev.smoother, (JacobiSmoother, ChebyshevSmoother))
        ):
            # block levels too; GS levels keep the plain sharded
            # block-ELL (the coloured sweep slices matrix rows)
            from .halo import halo_block_ell

            new_A.append(halo_block_ell(A, mesh, pl))
        else:
            new_A.append(_shard_mat(A, pl, pl, dev, True))
    new_levels = []
    for li, lev in enumerate(op.levels):
        j, pl = js[li], pls[li]
        sm = _shard_smoother(lev.smoother, lev.A, pl, mesh, dev)
        P_s = R_s = None
        if lev.P is not None:
            cpl = pls[li + 1]
            if isinstance(lev.P, LatticeProlongation) and (pl.j > 1
                                                           or cpl.j > 1):
                A_s = new_A[li]
                Dinv = _dinv_rows(lev.P.Dinv, pl, dev)
                P_s = ShardedLatticeProlongation(
                    P=lev.P, A=A_s, Dinv=Dinv, src=cpl, dst=pl
                )
                R_s = ShardedLatticeRestriction(
                    R=lev.R, A=A_s, Dinv=_dinv_rows(lev.R.Dinv, pl, dev),
                    src=pl, dst=cpl,
                )
            elif isinstance(lev.P, LatticeProlongation):
                P_s = _lattice_to(lev.P, new_A[li], dev)
                R_s = _lattice_to(lev.R, new_A[li], dev)
            else:
                # P rows live on this (fine) level; on PARTIALLY-replicated
                # (contraction) levels P stays replicated, as in the JAX
                # package; R is replicated
                P_s = _shard_mat(
                    lev.P, cpl, pl, dev, rows_sharded=(j == n or j <= 1)
                )
                R_s = _shard_mat(lev.R, pl, cpl, dev, rows_sharded=False)
        new_levels.append(
            DeviceLevel(A=new_A[li], smoother=sm, P=P_s, R=R_s)
        )
    cinv = None if op.coarse_inv is None else op.coarse_inv.to(dev)
    cc = op.cluster_corr
    if cc is not None:
        cc = _to_device(cc, dev)
        if pls[0].j > 1:
            cc = ShardedCluster(cc=cc, pl=pls[0])
    op_s = AMGOperator(
        levels=tuple(new_levels),
        coarse_inv=cinv,
        cluster_corr=cc,
        cycle=op.cycle,
    )
    return op_s, new_levels[0].A


def _lattice_to(T, A_dev, dev):
    """A replicated lattice transfer on ``dev`` over the level's staged
    operator (shared, as on one device)."""
    import dataclasses

    return dataclasses.replace(T, A=A_dev, Dinv=T.Dinv.to(dev))


def level_shard_counts(op: AMGOperator) -> tuple[int, ...]:
    """Row-shard count per level: the number of ranks the level's stored
    operator rows are partitioned over. A ``StencilDia`` level stores no
    rows (its values are replicated) and counts 1, as in the JAX package,
    though its vectors are row-sharded."""
    out = []
    for lev in op.levels:
        pl = getattr(lev.A, "placement", None)
        whole = not getattr(lev.A, "local_rows", True)
        out.append(1 if pl is None or whole else pl.j)
    return tuple(out)


def local_rows(A0_s, v: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a full finest-level vector."""
    pl = getattr(A0_s, "placement", None)
    return v if pl is None else pl.take(v)


def gather_rows(A0_s, v: torch.Tensor) -> torch.Tensor:
    """The full finest-level vector from every rank's rows."""
    pl = getattr(A0_s, "placement", None)
    return v if pl is None else pl.gather(v)
