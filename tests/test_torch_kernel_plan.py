"""Launch plans of the port's K1 (stencil), K2 (DIA) and K3 (symmetric-half
DIA) kernels, on the CPU.

The wrappers compute each kernel's launch plan from the level's shape when
the level is staged (ops/stencil_cuda.py ``stencil_plan``, ops/dia_cuda.py
``dia_plan`` and ``dia_sym_plan``). These tests check the plans at the headline's level shapes,
at ``unstructured_poisson(20, 3)``'s DIA level and at the odd shapes of
chip_smoke.py's build phase: each fits a block's shared memory and covers
every output row exactly once.

A numpy walk of the same tiles, halos, plane ring, diagonal groups and
load batches computes y as the kernels do. It is held, at rtol 1e-5, to the plain
PyTorch version and to the JAX package's Pallas kernels run in interpret
mode (as tests/test_pallas_interpret.py runs them), on seeded odd shapes.
The bf16 plans are walked too: the walk sums the bf16 values in f32 and
rounds once, as the bf16 kernels do, and is held to the plain bf16
version at 1e-2 of max |y| (a bf16 ulp is 2^-8 relative; the two sum in
different orders before that one rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsamg_tpu.ops.dia_pallas import dia_matvec_pallas
from ngsamg_tpu.ops.stencil_pallas import stencil_matvec_pallas
from ngsamg_tpu.sparse import formats as jf
from ngsamg_tpu_torch.ops import dia_cuda, stencil_cuda
from ngsamg_tpu_torch.sparse import formats as tf

torch.set_num_threads(2)

SMEM_PER_BLOCK = 232_448  # 227 KB: the most an H100 block can use
TILE = 8192  # the JAX DIA kernel's row tile (LANES * ROWS_PER_TILE)

# the headline's level-0 stencil (P1 on Kuhn tetrahedra), in its order
HEADLINE_STENCIL = (
    (-1, -1, -1), (-1, -1, 0), (-1, 0, -1), (-1, 0, 0), (0, -1, -1),
    (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
    (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
)
SEVEN_POINT = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
               (0, 0, 1), (0, 0, -1))
CUBE = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
             for c in (-1, 0, 1))
SHUFFLED_CUBE = tuple(CUBE[i] for i in np.random.default_rng(7).permutation(27))

# the headline's DIA levels 3 and 4 (poisson_3d(216) on one H100):
# (rows, nrows_pad, diagonals, min offset, max offset)
HEADLINE_DIA = [(19683, 19688, 81, -1486, 1486), (2744, 2744, 251, -617, 617)]

BF16 = "bfloat16"  # the dtype parameter of the bf16 cases (numpy has none)
DTYPES = [np.float32, np.float64, BF16]


def _itemsize(dtype) -> int:
    return 2 if dtype == BF16 else np.dtype(dtype).itemsize


def _acc_bytes(itemsize: int) -> int:
    """A partial sum's bytes: the kernels sum bf16 in f32."""
    return max(itemsize, 4)


def _bf16_round(a) -> np.ndarray:
    """f32 values rounded to bf16 (round to nearest even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _host_values(a, dtype) -> np.ndarray:
    """Seeded values in the case's dtype; bf16 ones as f32 numpy."""
    if dtype == BF16:
        return _bf16_round(a)
    return np.asarray(a).astype(dtype)


def _tensor(a, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == BF16 else t


def _values(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy (bf16 exactly, as f32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _check_against_plain(y, y_plain, dtype):
    """The walk against the plain version: rtol 1e-5 in f32 and f64; in
    bf16 the walk's f32 sum rounded once, to 1e-2 of max |y|."""
    if dtype == BF16:
        np.testing.assert_allclose(
            _bf16_round(y), y_plain, rtol=0,
            atol=1e-2 * np.abs(y_plain).max())
    else:
        np.testing.assert_allclose(y, y_plain, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# numpy walks of the kernels' blocks
# ---------------------------------------------------------------------------


def _axis_cover(extent, tile, ntiles):
    """How often each index of an axis is owned by one of its tiles."""
    cover = np.zeros(extent, dtype=int)
    for k in range(ntiles):
        cover[k * tile: min((k + 1) * tile, extent)] += 1
    return cover


def kernel_tap_offsets(taps, plan):
    """Each tap's shared-memory offset from the thread's cell in the
    three-plane window, as the kernel's launch computes it from the
    (dz, dy, dx) that the wrapper passes."""
    h = plan.halo
    hx = plan.tile[1] + 2 * h
    psz = hx * (plan.tile[0] + 2 * h)
    d = np.asarray(list(taps)).reshape(-1, 3)
    return (d[:, 0] + h) * psz + (d[:, 1] + h) * hx + d[:, 2] + h


def walk_stencil(A, x, plan):
    """The tiled K1 kernel, block by block: halo-padded planes in a ring of
    RING_SLOTS (plane p in slot (p - z0 + 1) % RING_SLOTS, slots below
    RING_MIRROR also in their mirrors after the ring), the taps read at
    their offsets in the window of three slots from (z - z0) % RING_SLOTS
    on, summed in ``A.offs`` order (zero-weight padding included).
    Returns y and the writes per row."""
    n0, n1, n2 = A.dims
    ty_n, tx_n = plan.tiles
    th, tw = plan.tile
    hy, hx = th + 2 * plan.halo, tw + 2 * plan.halo
    psz = hy * hx
    slots, mirror = stencil_cuda.RING_SLOTS, stencil_cuda.RING_MIRROR
    assert plan.smem_bytes == (slots + mirror) * psz * A.vals.element_size()
    off = kernel_tap_offsets(A.launch.taps, plan)
    w = np.zeros(stencil_cuda.MAX_TAPS, dtype=x.dtype)
    w[: len(A.offs)] = _values(A.vals)
    xl = x[: A.nrows].reshape(A.dims)
    y = np.full(A.nrows_pad, np.nan, dtype=x.dtype)
    writes = np.zeros(A.nrows_pad, dtype=int)
    y[A.nrows:] = 0  # block 0 zeroes the pad tail
    writes[A.nrows:] += 1
    cy, cx = np.divmod(np.arange(th * tw), tw)
    cells = cy * hx + cx  # each thread's cell in a ring plane

    def plane(z, y0, x0):
        p = np.zeros((hy, hx), dtype=x.dtype)
        if 0 <= z < n0:
            ys, xs = max(y0 - 1, 0), max(x0 - 1, 0)
            ye, xe = min(y0 - 1 + hy, n1), min(x0 - 1 + hx, n2)
            p[ys - (y0 - 1): ye - (y0 - 1), xs - (x0 - 1): xe - (x0 - 1)] = \
                xl[z, ys:ye, xs:xe]
        return p.reshape(-1)

    for b in range(plan.blocks):
        tile = b % (ty_n * tx_n)
        y0, x0 = (tile // tx_n) * th, (tile % tx_n) * tw
        z0 = (b // (ty_n * tx_n)) * plan.chunk
        z1 = min(z0 + plan.chunk, n0)
        gy, gx = y0 + cy, x0 + cx
        live = (gy < n1) & (gx < n2)
        ring = np.full((slots + mirror) * psz, np.nan, dtype=x.dtype)
        for p in range(z0 - 1, z1 + 1):  # the planes the chunk reads
            s = (p - z0 + 1) % slots
            for slot in (s, s + slots) if s < mirror else (s,):
                ring[slot * psz: (slot + 1) * psz] = plane(p, y0, x0)
            if p < z0 + 1:
                continue
            z = p - 1  # planes z - 1, z, z + 1 are in the ring
            win = cells + ((z - z0) % slots) * psz
            acc = np.zeros(th * tw, dtype=x.dtype)
            for t in range(plan.ntaps):
                acc = acc + w[t] * ring[win + off[t]]
            g = z * n1 * n2 + gy[live] * n2 + gx[live]
            y[g] = acc[live]
            writes[g] += 1
    return y, writes


def walk_dia(A, x, plan):
    """The split-diagonal K2 kernel, block by block: the x window (or
    bounds-checked reads on the ldg path), one partial sum per diagonal
    group, reduced in group order. Returns y, the writes per row and how
    often each block visits each diagonal."""
    n_pad = A.nrows_pad
    data = _values(A.data)
    offs = np.asarray(A.offsets)
    ndiag = len(offs)
    y = np.full(n_pad, np.nan, dtype=x.dtype)
    writes = np.zeros(n_pad, dtype=int)
    visits = np.zeros((plan.blocks, ndiag), dtype=int)
    lanes = np.arange(plan.tile)
    for b in range(plan.blocks):
        rows = b * plan.tile + lanes
        live = rows < n_pad
        rc = np.minimum(rows, n_pad - 1)
        if plan.path == "smem":
            j = b * plan.tile + plan.lo + np.arange(plan.window)
            win = np.where((j >= 0) & (j < n_pad),
                           x[np.clip(j, 0, n_pad - 1)], 0).astype(x.dtype)
        part = np.zeros((plan.groups, plan.tile), dtype=x.dtype)
        for g in range(plan.groups):
            for d in range(g * plan.per_group,
                           min((g + 1) * plan.per_group, ndiag)):
                visits[b, d] += 1
                if plan.path == "smem":
                    k = lanes + offs[d] - plan.lo
                    assert k.min() >= 0 and k.max() < plan.window
                    v = win[k]
                else:
                    jj = rows + offs[d]
                    v = np.where((jj >= 0) & (jj < n_pad),
                                 x[np.clip(jj, 0, n_pad - 1)], 0)
                part[g] = part[g] + data[d, rc] * v.astype(x.dtype)
        s = part[0]
        for g in range(1, plan.groups):
            s = s + part[g]
        y[rows[live]] = s[live]
        writes[rows[live]] += 1
    return y, writes, visits


def walk_dia_sym(A, x, plan):
    """The tiled K3 kernel, block by block: a tile of ``tpg * SYM_ROWS``
    rows, each diagonal group's diagonals in batches of
    ``batch`` and then one by one, per diagonal the plus term before the
    minus term, an index outside [0, n_pad) clamped to the thread's own
    row with its data zeroed (tiles at least ``reach`` inside skip the
    tests and must not need them), the groups' partial sums added in group
    order. Returns y, the writes per row, and how often each stored entry
    was used in the plus and in the minus direction."""
    n_pad = A.nrows_pad
    data = _values(A.data)
    offs = np.asarray(A.offsets)
    ndiag = len(offs)
    y = np.full(n_pad, np.nan, dtype=x.dtype)
    writes = np.zeros(n_pad, dtype=int)
    used = np.zeros((2, ndiag, n_pad), dtype=int)
    assert plan.tile == plan.tpg * dia_cuda.SYM_ROWS
    for b in range(plan.blocks):
        r0 = b * plan.tile
        rows = r0 + np.arange(plan.tile)
        live = rows < n_pad  # whole threads: n_pad % SYM_ROWS == 0
        own = np.minimum(rows, n_pad - 1)
        inside = r0 >= plan.reach and r0 + plan.tile + plan.reach <= n_pad
        part = np.zeros((plan.groups, plan.tile), dtype=x.dtype)
        for g in range(plan.groups):
            d0 = g * plan.per_group
            d1 = min(d0 + plan.per_group, ndiag)
            nfull = max(d1 - d0, 0) // plan.batch * plan.batch
            batches = [range(d, d + plan.batch)
                       for d in range(d0, d0 + nfull, plan.batch)]
            batches += [range(d, d + 1) for d in range(d0 + nfull, d1)]
            for batch in batches:
                loaded = []
                for d in batch:  # every load of the batch first
                    jp, jm = rows + offs[d], rows - offs[d]
                    if inside:
                        assert jp.max() < n_pad and jm.min() >= 0
                    okp = live & (jp < n_pad)
                    okm = live & (offs[d] > 0) & (jm >= 0)
                    cm = np.where(live & (jm >= 0), jm, own)
                    cp = np.where(okp, jp, own)
                    loaded.append((np.where(okp, data[d, own], 0), x[cp],
                                   np.where(okm, data[d, cm], 0), x[cm]))
                    used[0, d, rows[okp]] += 1
                    used[1, d, jm[okm]] += 1
                for ap, xp, am, xm in loaded:  # then the sums, in order
                    part[g] = part[g] + (ap * xp).astype(x.dtype)
                    part[g] = part[g] + (am * xm).astype(x.dtype)
        s = part[0]
        for g in range(1, plan.groups):
            s = s + part[g]
        y[rows[live]] = s[live]
        writes[rows[live]] += 1
    return y, writes, used


# ---------------------------------------------------------------------------
# K1 plans
# ---------------------------------------------------------------------------


def _stencil_case(dims, offs, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(dims))
    vals = _host_values(rng.standard_normal(len(offs)), dtype)
    offs = tuple(tuple(int(v) for v in o) for o in offs)
    dims = tuple(int(d) for d in dims)
    n_pad = -(-n // 8) * 8
    A_t = tf.StencilDia(vals=_tensor(vals, dtype), offs=offs, dims=dims,
                        nrows=n, nrows_pad=n_pad)
    A_j = jf.StencilDia(vals=jnp.asarray(vals), offs=offs, dims=dims,
                        nrows=n, nrows_pad=n_pad)
    x = np.zeros(n_pad, dtype=vals.dtype)
    x[:n] = _host_values(rng.standard_normal(n), dtype)
    return A_t, A_j, x


def _check_stencil_plan(plan, dims, m):
    assert plan.variant == "tiled3d"
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.halo == 1 and plan.tile == (stencil_cuda.TILE_Y,
                                            stencil_cuda.TILE_X)
    assert plan.ntaps in stencil_cuda.TAP_COUNTS and plan.ntaps >= m
    n0, n1, n2 = dims
    ty_n, tx_n = plan.tiles
    nchunks = -(-n0 // plan.chunk)
    assert plan.blocks == ty_n * tx_n * nchunks < 2**31
    # every lattice row exactly once: each axis partition covers its axis
    for extent, tile, ntiles in ((n0, plan.chunk, nchunks),
                                 (n1, plan.tile[0], ty_n),
                                 (n2, plan.tile[1], tx_n)):
        assert (_axis_cover(extent, tile, ntiles) == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_headline_stencil_plan(itemsize):
    """Level 0 of poisson_3d(216): the tiled variant, 15 taps; the bf16
    ring takes half the f32 bytes."""
    dims = (215, 215, 215)
    plan = stencil_cuda.stencil_plan(HEADLINE_STENCIL, dims, itemsize)
    _check_stencil_plan(plan, dims, 15)
    assert plan.ntaps == 15
    assert plan.tiles == (14, 7)
    assert plan.smem_bytes == 10 * 18 * 34 * itemsize  # 8 slots + 2 mirrors
    assert plan.smem_bytes <= 48 * 1024  # no opt-in, in f64 too
    assert plan.blocks >= 132  # the grid fills every SM of an H100


@pytest.mark.parametrize(
    "dims,offs,variant,ntaps",
    [
        ((7, 9, 11), SEVEN_POINT, "tiled3d", 7),
        ((13, 19, 45), HEADLINE_STENCIL, "tiled3d", 15),
        ((2, 3, 5), SHUFFLED_CUBE, "tiled3d", 27),
        ((5, 4, 38), ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 0, 2),
                      (1, 1, -1), (-1, -1, 1)), "general", 6),
        ((33, 131), ((0, 0), (2, 0), (-2, 0), (0, 3), (0, -3), (1, 1),
                     (-1, -1)), "general", 7),
    ],
)
def test_stencil_variant_from_shape(dims, offs, variant, ntaps):
    """The variant comes from the shape alone; the staged level holds the
    plan and the kernel's parameters."""
    A_t, _, _ = _stencil_case(dims, offs)
    plan = A_t.launch.plan
    assert plan == stencil_cuda.stencil_plan(offs, dims, 4)
    assert plan.variant == variant and plan.ntaps == ntaps
    if variant == "general":
        assert A_t.launch.meta.dtype == torch.int64
        assert A_t.launch.weights is None
        return
    _check_stencil_plan(plan, dims, len(offs))
    assert list(A_t.launch.weights) == pytest.approx(
        A_t.vals.tolist() + [0.0] * (stencil_cuda.MAX_TAPS - len(offs)))
    pad = stencil_cuda.MAX_TAPS - len(offs)
    assert list(A_t.launch.taps) == [v for o in offs for v in o] + [0] * 3 * pad
    assert A_t.launch.meta is None


def test_tap_offsets_address_the_right_cell():
    """The launch passes the taps as (dz, dy, dx) in ``offs`` order; the
    kernel's offset of tap (dz, dy, dx) reads plane dz + 1 of the
    three-plane window, row dy + 1 and column dx + 1 of the thread's 3 x 3
    neighbourhood; padded taps read the output cell itself."""
    hx = stencil_cuda.TILE_X + 2
    psz = hx * (stencil_cuda.TILE_Y + 2)
    A, _, _ = _stencil_case((2, 3, 5), SHUFFLED_CUBE)
    off = kernel_tap_offsets(A.launch.taps, A.launch.plan)
    for t, (dz, dy, dx) in enumerate(SHUFFLED_CUBE):
        plane, rest = divmod(int(off[t]), psz)
        assert (plane, *divmod(rest, hx)) == (dz + 1, dy + 1, dx + 1)
    B, _, _ = _stencil_case((7, 9, 11), SEVEN_POINT)
    pad = kernel_tap_offsets(B.launch.taps, B.launch.plan)[7:]
    assert pad.tolist() == [psz + hx + 1] * (stencil_cuda.MAX_TAPS - 7)


@pytest.mark.parametrize(
    "dims,offs,target",
    [
        ((7, 9, 11), SEVEN_POINT, None),
        ((13, 19, 45), HEADLINE_STENCIL, None),
        ((2, 3, 5), SHUFFLED_CUBE, None),
        # few target blocks, so that a block marches over many planes:
        # chunks of 7 and 6 planes (the ring wraps once), of 5 and 4, and
        # of 11 and 10 (the window crosses the mirrored slots twice)
        ((13, 19, 45), HEADLINE_STENCIL, 12),
        ((9, 17, 70), SHUFFLED_CUBE, 18),
        ((21, 9, 40), SHUFFLED_CUBE, 8),
    ],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stencil_walk_matches_plain_and_jax(dims, offs, target, dtype,
                                            monkeypatch):
    if target is not None:
        monkeypatch.setattr(stencil_cuda, "TARGET_BLOCKS", target)
    A_t, A_j, x = _stencil_case(dims, offs, dtype, seed=sum(dims))
    plan = stencil_cuda.stencil_plan(A_t.offs, A_t.dims, _itemsize(dtype))
    assert plan == A_t.launch.plan
    if target is not None:
        assert 1 < plan.chunk < dims[0]
    _check_stencil_plan(plan, dims, len(offs))
    y, writes = walk_stencil(A_t, x, plan)
    assert (writes == 1).all()
    y_plain = _values(stencil_cuda._stencil_matvec_plain(
        A_t, _tensor(x, dtype)[:, None]))[:, 0]
    _check_against_plain(y, y_plain, dtype)
    if dtype == np.float32:
        y_pl = np.asarray(stencil_matvec_pallas(
            A_j, jnp.asarray(x)[:, None], interpret=True))[:, 0]
        np.testing.assert_allclose(y, y_pl, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(y[A_t.nrows:], 0.0)


# ---------------------------------------------------------------------------
# K2 plans
# ---------------------------------------------------------------------------


def _check_dia_plan(plan, offsets, n_pad, itemsize):
    ndiag = len(offsets)
    assert plan.smem_bytes <= dia_cuda.SMEM_BUDGET <= SMEM_PER_BLOCK
    assert plan.tile == 32 and 1 <= plan.groups <= dia_cuda.MAX_GROUPS
    # every diagonal in exactly one group, no group empty
    assert (plan.groups - 1) * plan.per_group < max(ndiag, 1)
    assert plan.groups * plan.per_group >= ndiag
    # every row in exactly one tile
    assert plan.blocks * plan.tile >= n_pad > (plan.blocks - 1) * plan.tile
    part = ndiag * 8 + plan.groups * plan.tile * _acc_bytes(itemsize)
    if plan.path == "smem":
        assert plan.window == plan.tile + max(offsets[-1], 0) \
            - min(offsets[0], 0)
        assert plan.smem_bytes == part + plan.window * itemsize
    else:
        assert plan.path == "ldg" and plan.window == 0
        assert plan.smem_bytes == part
        assert part + (plan.tile + offsets[-1] - offsets[0]) * itemsize \
            > dia_cuda.SMEM_BUDGET


@pytest.mark.parametrize("rows,n_pad,ndiag,lo,hi", HEADLINE_DIA)
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_headline_dia_plans(rows, n_pad, ndiag, lo, hi, itemsize):
    """Levels 3 and 4 of poisson_3d(216): the smem path, with the
    diagonals split over up to 16 warps."""
    # the plan reads the count and the extreme offsets only
    offsets = tuple(int(o) for o in np.linspace(lo, hi, ndiag).round())
    assert len(set(offsets)) == ndiag
    plan = dia_cuda.dia_plan(offsets, n_pad, itemsize)
    _check_dia_plan(plan, offsets, n_pad, itemsize)
    assert plan.path == "smem"
    assert plan.groups == min(16, -(-len(offsets) // 8))
    assert plan.blocks == -(-n_pad // 32)


def test_unstructured_dia_level_plan():
    """Level 0 of unstructured_poisson(20, 3), staged on the CPU: K2's
    plan at that level's shape, and the walk against the plain version."""
    from ngsamg_tpu_torch import AMGOptions, AMGPreconditioner
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType
    from ngsamg_tpu_torch.utils import fem

    q = fem.unstructured_poisson(20, dim=3)
    opts = AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
    pc = AMGPreconditioner(q.A, coords=q.coords, options=opts, device="cpu")
    A = pc.setup().op.levels[0].A
    assert isinstance(A, tf.DiaMatrix) and not A.sym_half
    assert (A.nrows, len(A.offsets)) == (6859, 81)
    plan = A.launch.plan
    _check_dia_plan(plan, A.offsets, A.nrows_pad, 4)
    assert plan.path == "smem" and plan.groups == 11
    x = np.zeros(A.nrows_pad, dtype=np.float32)
    x[: A.nrows] = np.random.default_rng(11).standard_normal(A.nrows)
    y, writes, visits = walk_dia(A, x, plan)
    assert (writes == 1).all() and (visits == 1).all()
    y_plain = dia_cuda._dia_matvec_plain(
        A, torch.from_numpy(x)[:, None]).numpy()[:, 0]
    np.testing.assert_allclose(y, y_plain, rtol=1e-5, atol=1e-5)


def _dia_case(offsets, n, dtype=np.float32, seed=0):
    n_pad = -(-n // TILE) * TILE
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n_pad),
                    dtype=np.float32 if dtype == BF16 else dtype)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = _host_values(rng.standard_normal(hi - lo), dtype)
    offsets = tuple(int(o) for o in offsets)
    A_t = tf.DiaMatrix(data=_tensor(data, dtype), offsets=offsets,
                       nrows=n, nrows_pad=n_pad)
    A_j = jf.DiaMatrix(data=jnp.asarray(data), offsets=offsets, nrows=n,
                       nrows_pad=n_pad, use_pallas=False)
    x = np.zeros(n_pad, dtype=data.dtype)
    x[:n] = _host_values(rng.standard_normal(n), dtype)
    return A_t, A_j, x


@pytest.mark.parametrize(
    "offsets,n,path",
    [
        ((-200, -128, -3, 0, 3, 128, 200), TILE - 77, "smem"),
        ((-300, 0, 300), 2 * TILE - 5, "smem"),
        # more diagonals than one warp takes: 41 over 6 warps
        (tuple(range(-60, 61, 3)), TILE - 31, "smem"),
        # a window larger than the shared-memory budget
        ((-40000, -1, 0, 1, 40000), 5 * TILE - 3, "ldg"),
    ],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_walk_matches_plain_and_jax(offsets, n, path, dtype):
    A_t, A_j, x = _dia_case(offsets, n, dtype, seed=len(offsets))
    plan = A_t.launch.plan
    size = _itemsize(dtype)
    assert plan == dia_cuda.dia_plan(offsets, A_t.nrows_pad, size)
    _check_dia_plan(plan, A_t.offsets, A_t.nrows_pad, size)
    assert plan.path == path
    y, writes, visits = walk_dia(A_t, x, plan)
    assert (writes == 1).all() and (visits == 1).all()
    y_plain = _values(dia_cuda._dia_matvec_plain(
        A_t, _tensor(x, dtype)[:, None]))[:, 0]
    _check_against_plain(y, y_plain, dtype)
    if dtype == np.float32:
        y_pl = np.asarray(dia_matvec_pallas(
            A_j, jnp.asarray(x)[:, None], interpret=True))[:, 0]
        np.testing.assert_allclose(y[:n], y_pl[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(y[n:], 0.0)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_dia_plan_refuses_too_many_diagonals(itemsize):
    """K2 keeps every offset and the groups' partial sums in shared memory:
    a level whose offsets alone pass the budget is refused when its plan
    is made (at staging), and one diagonal fewer still fits."""
    part = dia_cuda.MAX_GROUPS * dia_cuda.TILE_ROWS * _acc_bytes(itemsize)
    fits = (dia_cuda.SMEM_BUDGET - part) // dia_cuda.OFFSET_BYTES
    plan = dia_cuda.dia_plan(tuple(range(fits)), 2 * fits, itemsize)
    assert plan.path == "ldg" and plan.smem_bytes <= dia_cuda.SMEM_BUDGET
    with pytest.raises(ValueError, match="shared memory"):
        dia_cuda.dia_plan(tuple(range(fits + 1)), 2 * fits, itemsize)
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    with pytest.raises(ValueError, match="shared memory"):
        tf.DiaMatrix(data=torch.zeros((fits + 1, 8), dtype=dtype),
                     offsets=tuple(range(fits + 1)), nrows=8, nrows_pad=8)


# ---------------------------------------------------------------------------
# K3 plans
# ---------------------------------------------------------------------------

# the stencils of the headline's symmetric-half levels 1 and 2
# (poisson_3d(216): 108^3 rows x 17 stored diagonals, 54^3 x 34), as lattice
# offsets (dz, dy, dx) whose linear offset dz L^2 + dy L + dx is >= 0
SYM_STENCIL_1 = (
    [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, -1), (0, 1, 0), (0, 1, 1),
     (0, 2, 0)]
    + [(1, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)] + [(2, 0, 0)]
)
SYM_STENCIL_2 = (
    [(0, 0, dx) for dx in (0, 1, 2)] + [(0, 1, dx) for dx in range(-2, 3)]
    + [(0, 2, dx) for dx in (-1, 0, 1)] + [(1, -2, 0)]
    + [(1, -1, dx) for dx in range(-1, 3)] + [(1, 0, dx) for dx in range(-2, 3)]
    + [(1, 1, dx) for dx in (-1, 0, 1)] + [(1, 2, -1), (1, 2, 0)]
    + [(2, -1, 0), (2, -1, 1)] + [(2, 0, dx) for dx in (-1, 0, 1)]
    + [(2, 1, dx) for dx in (-1, 0, 1)]
)
HEADLINE_SYM = [(108, SYM_STENCIL_1), (54, SYM_STENCIL_2)]


def _lattice_offsets(stencil, L):
    return tuple(sorted(dz * L * L + dy * L + dx for dz, dy, dx in stencil))


def _check_dia_sym_plan(plan, offsets, n_pad, itemsize):
    ndiag = len(offsets)
    assert plan.smem_bytes <= dia_cuda.SMEM_BUDGET <= SMEM_PER_BLOCK
    assert n_pad % dia_cuda.SYM_ROWS == 0
    assert plan.batch == (dia_cuda.SYM_BATCH_SPLIT if plan.groups > 1
                          else dia_cuda.SYM_BATCH_STREAM)
    assert plan.tpg % 32 == 0 and plan.tpg * plan.groups == \
        dia_cuda.SYM_THREADS
    assert plan.tile == plan.tpg * dia_cuda.SYM_ROWS
    # every diagonal in exactly one group
    assert plan.groups * plan.per_group >= ndiag
    assert plan.groups == 1 or plan.per_group >= dia_cuda.SYM_DIAGS_PER_GROUP
    # every row in exactly one tile
    assert plan.blocks * plan.tile >= n_pad > (plan.blocks - 1) * plan.tile
    assert plan.reach == max(offsets)
    part = (plan.groups * plan.tile * _acc_bytes(itemsize)
            if plan.groups > 1 else 0)
    assert plan.smem_bytes == part + 8 * ndiag


@pytest.mark.parametrize("L,stencil", HEADLINE_SYM)
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_headline_dia_sym_plans(L, stencil, itemsize):
    """Levels 1 and 2 of poisson_3d(216): the offsets are the ones the
    hierarchy stages, the large level runs one group, the small one
    splits its diagonals in two to fill the card."""
    offsets = _lattice_offsets(stencil, L)
    if L == 108:
        assert offsets == (0, 1, 2, 107, 108, 109, 216, 11555, 11556, 11557,
                           11663, 11664, 11665, 11771, 11772, 11773, 23328)
    else:
        assert len(offsets) == 34 and offsets[-4:] == (5833, 5885, 5886, 5887)
    n = L ** 3
    plan = dia_cuda.dia_sym_plan(offsets, n, itemsize)
    _check_dia_sym_plan(plan, offsets, n, itemsize)
    assert plan.blocks >= 132  # the grid fills every SM of an H100
    if L == 108:
        assert plan.variant == "tile-r2-u2-g1" and plan.blocks == 2461
    else:
        assert plan.variant == "tile-r2-u4-g2" and plan.per_group == 17
        assert plan.blocks * dia_cuda.SYM_THREADS >= \
            dia_cuda.SYM_TARGET_THREADS


def _dia_sym_case(offsets, n, n_pad=None, dtype=np.float32, seed=0):
    if n_pad is None:
        n_pad = -(-n // TILE) * TILE
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n_pad),
                    dtype=np.float32 if dtype == BF16 else dtype)
    for d, off in enumerate(offsets):
        data[d, : max(n - off, 0)] = _host_values(
            rng.standard_normal(max(n - off, 0)), dtype)
    offsets = tuple(int(o) for o in offsets)
    A_t = tf.DiaMatrix(data=_tensor(data, dtype), offsets=offsets,
                       nrows=n, nrows_pad=n_pad, sym_half=True)
    A_j = None
    if n_pad % TILE == 0:  # the JAX kernel's row tile
        A_j = jf.DiaMatrix(data=jnp.asarray(data), offsets=offsets, nrows=n,
                           nrows_pad=n_pad, use_pallas=False, sym_half=True)
    x = np.zeros(n_pad, dtype=data.dtype)
    x[:n] = _host_values(rng.standard_normal(n), dtype)
    return A_t, A_j, x


SYM_CASES = {
    # the headline's level-1 and level-2 stencils on lattices cut to 20^3
    # and 16^3 (one group, and the diagonals split over groups)
    "level1-20": (_lattice_offsets(SYM_STENCIL_1, 20), 20 ** 3, None),
    "level2-16": (_lattice_offsets(SYM_STENCIL_2, 16), 16 ** 3, None),
    # n not a multiple of the tile, n_pad even and not a multiple of 8
    "level1-12-ragged": (_lattice_offsets(SYM_STENCIL_1, 12), 12 ** 3 - 5,
                         12 ** 3 - 2),
    "level2-13-ragged": (_lattice_offsets(SYM_STENCIL_2, 13), 13 ** 3,
                         13 ** 3 + 1),
    # an offset larger than a tile; no tile is far enough inside
    "offset-over-tile": ((0, 1, 127, 128, 5000), TILE - 13, None),
    # an offset larger than a block's shared memory could window
    "offset-over-smem": ((0, 128, 40000), 5 * TILE - 3, None),
    # no main diagonal stored; a single diagonal
    "no-diagonal": ((3, 64, 700), 3000, 3000),
    "one-diagonal": ((0,), 1001, 1008),
}


@pytest.mark.parametrize("case", sorted(SYM_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_sym_walk_matches_plain_and_jax(case, dtype):
    offsets, n, n_pad = SYM_CASES[case]
    A_t, A_j, x = _dia_sym_case(offsets, n, n_pad, dtype, seed=len(offsets))
    plan = A_t.launch.plan
    size = _itemsize(dtype)
    assert plan == dia_cuda.dia_sym_plan(offsets, A_t.nrows_pad, size)
    _check_dia_sym_plan(plan, A_t.offsets, A_t.nrows_pad, size)
    y, writes, used = walk_dia_sym(A_t, x, plan)
    assert (writes == 1).all()
    # every stored entry (row g of offset o with g + o inside) is used
    # once in each direction, the main diagonal in the plus direction only
    for d, o in enumerate(A_t.offsets):
        stored = np.arange(A_t.nrows_pad) + o < A_t.nrows_pad
        np.testing.assert_array_equal(used[0, d], stored.astype(int))
        np.testing.assert_array_equal(
            used[1, d], (stored & (o > 0)).astype(int))
    y_plain = _values(dia_cuda._dia_matvec_plain(
        A_t, _tensor(x, dtype)[:, None]))[:, 0]
    _check_against_plain(y, y_plain, dtype)
    if dtype == np.float32 and A_j is not None:
        y_pl = np.asarray(dia_matvec_pallas(
            A_j, jnp.asarray(x)[:, None], interpret=True))[:, 0]
        np.testing.assert_allclose(y[:n], y_pl[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(y[n:], 0.0)


def test_dia_sym_plan_follows_the_shape():
    """The plan reads the shape alone: groups from the rows and the
    diagonal count, the batch from the groups; the same for bf16, f32 and
    f64."""
    offs = _lattice_offsets(SYM_STENCIL_2, 54)
    for itemsize in (2, 4, 8):
        big = dia_cuda.dia_sym_plan(offs, 10 ** 7, itemsize)
        assert big.variant == "tile-r2-u2-g1"
        mid = dia_cuda.dia_sym_plan(offs, 100008, itemsize)
        assert mid.variant == "tile-r2-u4-g4"
        small = dia_cuda.dia_sym_plan(offs, 4096, itemsize)
        assert small.variant == "tile-r2-u4-g8"
        assert small.tpg == 32 and small.per_group == 5
        few = dia_cuda.dia_sym_plan((0, 1, 64), 4096, itemsize)
        assert few.groups == 1  # too few diagonals to split


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_dia_sym_plan_refuses_too_many_diagonals(itemsize):
    """K3 keeps every offset in shared memory: a level whose offsets pass
    the budget is refused when it is staged; negative offsets are refused
    there too."""
    fits = dia_cuda.SMEM_BUDGET // dia_cuda.OFFSET_BYTES
    n = 10 ** 7  # one group: no partial sums
    plan = dia_cuda.dia_sym_plan(tuple(range(fits)), n, itemsize)
    assert plan.groups == 1 and plan.smem_bytes == dia_cuda.SMEM_BUDGET
    with pytest.raises(ValueError, match="shared memory"):
        dia_cuda.dia_sym_plan(tuple(range(fits + 1)), n, itemsize)
    data = torch.zeros((2, 64))
    A = tf.DiaMatrix(data=data, offsets=(0, 5), nrows=60, nrows_pad=64,
                     sym_half=True)
    assert isinstance(A.launch.plan, dia_cuda.DiaSymPlan)
    assert A.launch.offs.tolist() == [0, 5]
    with pytest.raises(ValueError, match="sym_half"):
        tf.DiaMatrix(data=data, offsets=(-5, 0), nrows=60, nrows_pad=64,
                     sym_half=True)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_dia_sym_plan_refuses_odd_padding(itemsize):
    """A K3 thread owns two rows: an odd padded row count is refused when
    the level is staged (the levels' padding is a multiple of 8)."""
    with pytest.raises(ValueError, match="multiple of 2"):
        dia_cuda.dia_sym_plan((0, 1, 64), 4097, itemsize)
    dtype = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}[itemsize]
    with pytest.raises(ValueError, match="multiple of 2"):
        tf.DiaMatrix(data=torch.zeros((2, 63), dtype=dtype), offsets=(0, 5),
                     nrows=60, nrows_pad=63, sym_half=True)
