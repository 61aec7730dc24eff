#!/usr/bin/env python3
"""Smoke run of ngsamg_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py    # poisson_3d(216), 9,938,375 DoF,
                             # unstructured_poisson(55, 3, refine=1), 1,411,632,
                             # unstructured_elasticity(36, 3, refine=1), 1,250,196,
                             # poisson_3d(101), 1,000,000 (GS and the cycles)
                             # stokes_tri(20, 3), 104,738 (Stokes bench leg)
                             # stokes_mac_2d(512), 523,264 (Stokes, MAC)
                             # poisson_3d(101) again through the
                             # host-distributed setup on 8 shards,
                             # then sharded over 8 gloo ranks

Phases, each of which raises (nonzero exit) on failure:

1. device — a CUDA device must exist; prints its name and the
   ``nvidia-smi`` name/power limit; turns TF32 off.
2. build — builds the CUDA kernels from ``ngsamg_tpu_torch/csrc`` with nvcc
   (timed), then holds each kernel against its plain PyTorch version on
   small odd shapes: the tiled K1 on planes that are not a multiple of its
   tile and on a lattice smaller than one tile (7, 15 and 27 taps), the
   general K1 on reach 2 and on a 2-d lattice (and the tiled launch must
   refuse a plan that does not match its geometry), K2 on both of its paths
   (an x window in shared memory, and the read-only cache where the
   window would not fit), K3 on every shape of plan it can select (one
   diagonal group and several, tiles too near the ends to skip the bounds
   tests; its launch must refuse a plan that does not match the kernel's
   layout); f32 and f64. The block-ELL kernel on random operators of
   every staged block shape (br, bcw in {1, 2, 3, 6}) and of two generic
   ones, f32, f64 and bf16, with the row counts and without them, on its
   own and on forced plans; its launch must refuse a plan that does not
   match its layout. The GS sweep kernel on random colour-sorted levels of
   bs 1, 2, 3 and 6, f32, f64 and bf16, on its own plan and on forced ones
   of both launch shapes, forward and backward, one and two steps, from
   zero and from a nonzero x, against its plain version on the card; the
   caller's x unwritten, two launches to the same bits, and a plan that
   does not match the kernels refused. The native setup extension builds
   beside nvcc.
2a. native — the port's native setup extension
   (``ngsamg_tpu_torch/native/kernels.cpp``, built with ``g++`` during
   phase 2): the build's seconds, ``g++ --version`` and whether
   ``Python.h`` was found; then each of the fifteen wrappers the block
   (elasticity) setup reaches against the numpy branch beside its call, on
   the finest level of ``unstructured_elasticity(12, dim=3, refine=1)``
   (48,660 DoF; ``native/parity.py``): integer outputs equal, float
   outputs within the wrapper's tolerance (``parity.TOLERANCES``, the one
   tests/test_torch_native.py holds; none looser than 1e-8), and the
   native branch called; and each of the sixteen scalar-setup and staging
   wrappers the same way on the finest and the first coarse level of
   ``unstructured_poisson(16, dim=3, refine=1)`` (32,720 DoF;
   ``parity.SCALAR_TOLERANCES``: edges, partners, aggregates, colours,
   cluster sets, permutations and tile columns equal, values to at most
   1e-10). All 31 wrappers are held. Every later host setup and staging
   runs on the native branches (``native.HAVE_NATIVE``, the default); a
   failed build raises.
3. main path — resets the kernel launch counters, assembles
   ``fem.poisson_3d(216)``, runs ``AMGPreconditioner(..., device="cuda")
   .setup()`` and ``solve(b, tol=1e-8, return_device=True)``, reads the
   counters, and checks levels, operator complexity, convergence, the true
   relative residual (host, f64, scipy) and that every kernel ran.
4. kernels at the main path's shapes — each kernel against its plain
   version on the staged levels of that hierarchy (max |err| / max |y|
   <= 1e-6 in f32, <= 1e-13 in f64: K1 keeps the sum order and only FMA
   contraction differs; K2 sums its diagonal groups apart, which stays
   far inside the f32 tolerance). Two launches on the same input must
   give the same bits. Per level: the device time per launch (CUDA events
   around the replay of a CUDA graph of 50 launches, over 50), the time
   of one launch after a write that sweeps the L2 (``cold_ms``), for K3
   the time of the one-thread-per-row kernel it replaced (``old_ms``,
   built here from ``csrc/probes/dia_sym_row.cu``), the single-call time (``call_ms``, which
   includes the wrapper's host time), the bytes (of the DIA data only the in-range entries) and
   the bound (bytes at 3.35 TB/s), the time of
   one PyTorch call for the same function (``library_ms``: conv3d for K1,
   cuSPARSE via ``torch.sparse.mm`` for K2/K3; the port never calls
   them), the plain version's time, and, beside the tiled K1, the general
   K1 on the same level. Then five warm solves (their median; the first
   one's launches per kernel are counted), and a small solve on the card
   against the same solve on the CPU.
5. unstructured path — resets the counters, assembles
   ``fem.unstructured_poisson(55, dim=3, refine=1)`` (perturbed Delaunay,
   one red refinement), sets it up on the card (generic level loop,
   tile-ELL levels and transfers, cluster correction) and solves it to
   1e-8 (f64 defect correction on the card, on the finest level's f64
   tile-ELL twin; ``x`` an f64 CUDA tensor), reads the counters; checks
   the level count, operator complexity, iterations, true relative
   residual and that every level and transfer is tile-ELL or dense; a
   warm second solve. Prints the setup's native calls (``native.CALLS``):
   each wrapper the JAX package's native run reaches on this path must
   have been called natively; the host setup and staging beside their
   record on the numpy branches, and the card's name and power limit.
   Then the staged cluster correction against its definition
   (``benchmark/reference/cluster_corr.py``) on the staged finest host
   matrix (``pc.staged_host_matrices()``): the same clusters as sets of
   rows, and ``cluster_apply`` within 1e-5 of max |z| of ``apply``.
6. tile-ELL — the median time per call (>= 20 calls, CUDA events) of the
   tile-ELL matvec (the hand-written kernel) of every tile-ELL level and
   transfer of that hierarchy, each held to the plain f64 product of its
   staged host matrix (within 1e-5 of max |y|, padding rows zero), and the
   f64 twin of the finest level (1e-12); the seconds the reference checks
   take. ``[tile-ell-kernel]``: on every one of those operators and the
   f64 twin, the kernel (``csrc/tile_ell_matvec.cu``, on the compact copy
   staged with the operator) against the plain torch product on the card
   (max |err| / max |y| <= 1e-6 in f32, <= 1e-14 in f64), two launches to
   the same bits; the device time a launch by CUDA-graph replay of 50 and
   after an L2 sweep, beside the plain product's (the time before the
   kernel) and the bound by the problem's count (each nonzero's value and
   4-byte column, a 4-byte row pointer a row and one more, x and y once,
   at 3.35 TB/s), and the copy's stored entries and plan. Phase 12 runs
   the same check on the GS hierarchy's tile-ELL transfers.
7. unstructured reference — ``unstructured_poisson(20, dim=3)`` (a DIA
   finest level under tile-ELL transfers and cluster correction) on the
   card against the CPU; K2 must launch. The card solve is then traced
   step by step twice, with K2 and with K2 swapped for its plain version,
   and the two residual histories are printed (a report, not a check).
8. MIS coarsening — ``unstructured_poisson(20, dim=3)`` with
   ``coarsen.algo = MIS`` on the card against the same solve on the CPU:
   the same level sizes, iterations within one, true relres <= 1e-8.

9. elasticity — assembles ``fem.unstructured_elasticity(36, dim=3,
   refine=1)`` (1,250,196 DoF), sets it up with ``energy="elasticity",
   block_size=3`` on the default device (block-ELL levels of 3x3 and 6x6
   blocks, 3x6 / 6x3 block transfers, symmetric scaling, the f64 coarse
   inverse), runs a warm-up ``solve(maxiter=2, mixed=True)`` and then
   ``solve(tol=1e-8, maxiter=120, mixed=True)`` twice (first and warm);
   checks that every tensor of the staged operator and the f64 twin are on
   the card, convergence, the true relative residual (host, f64, scipy)
   <= 1e-8, at most 40 iterations and within one of the JAX package's
   native record (38). Prints the native calls of the setup
   (``native.CALLS``); each wrapper the JAX package's native run reaches
   on this path must have been called natively. The host setup is printed
   beside the 183.6 s this phase took on the numpy branches (PERF.md
   section 5).
10. block-ELL — the block-ELL kernel (``csrc/bell_matvec.cu``) on every
   block-ELL level and transfer of that hierarchy in f32, and on the
   finest level's f64 twin: against its plain version on the card (max
   |err| / max |y| <= 1e-5 in f32, <= 1e-12 in f64: a row sums up to
   ~2,000 terms in another order than torch's reduction), two launches
   to the same bits; the device time per call (CUDA-graph replay), after
   an L2 sweep, with every other launch plan (the sweep) and of the plain
   version, beside the bound by the problem's count (each stored block,
   its column index, the row pointers, x and y once, at 3.35 TB/s; as
   ``benchmark/roofline.py`` counts the finest level) and the bound of
   the padded storage. Phase 9's warm solve must have launched the
   kernel in f32 and f64.
11. elasticity reference — ``elasticity_3d(8)`` (19,440 DoF) solved on the
   card and on the CPU, ``mixed=True`` and plain: true relres <= 1e-8,
   solutions to 1e-6 relative, the mixed iterations within one; the plain
   f32 count follows the rounding (its spread over six rescalings of b is
   printed), so the plain path is held within one iteration in f64; ``bell.spmv`` on the card against the CPU
   at block shapes (3,3), (6,6), (3,6), (6,3) to rtol 1e-5.
12. gs — assembles ``fem.poisson_3d(101)`` (1,000,000 DoF, the GS leg of
   the JAX package's bench) once and solves it on the card with
   ``AMGOptions()`` unchanged (multicolor GS, V-cycle: block-ELL levels
   sorted by color) and then with the Chebyshev smoother (lattice levels,
   K1-K3); for each: levels, operator complexity, colors per level,
   iterations, true relres, host setup, staging, first solve, the median
   of 3 warm solves and the kernel launches of one warm solve counted by
   ``torch.profiler``; and the ratio of the two warm solves. GS must give
   the JAX package's 5 levels, operator complexity 2.076 (0.5%), colors
   2, 16, 56, 199, at most 16 iterations and true relres <= 1e-8, with
   every staged tensor on the card. Each setup's native calls are printed
   and checked as in phase 5 (GS: the native coloring among them), with
   the GS run's host setup and staging beside their numpy-branch record.
   ``[gs-kernel]``: on levels 0-3 of the GS hierarchy, a forward and a
   backward sweep from a nonzero x by the GS kernel against
   ``benchmark/reference/gs_sweep.py``'s ``blocked_sweep`` in float64 on
   the level's own matrix (max |err| / max |y| <= 2e-5), each level on
   the launch shape its plan takes (levels 0-1 a launch a colour step,
   2-3 one a sweep); the device time a sweep of the kernel and of the
   plain version (CUDA-graph replay), the kernel after an L2 sweep, and
   one call of each with its host time.
13. cycles — the same problem on the lattice path with the W-cycle and
   the BS cycle (Chebyshev), and Jacobi and l1-Jacobi V-cycles: iterations
   within one of the JAX package's (9, 6, 23, 23), true relres <= 1e-8,
   and K1, K2 and K3 each launched in one warm solve of every run (their
   counts go into the kernels line as ``launches_W``/``launches_BS``).
14. gs reference — card against CPU: ``poisson_3d(24)`` and
   ``elasticity_3d(8)`` (mixed and plain) with the default options,
   dyn-block GS on ``poisson_2d(32)`` in f64, and the stationary
   ``amg_iteration`` on ``poisson_3d(24)`` in f64: iterations equal or
   within one (the plain elasticity solve within 10%: its f32 defect
   correction stalls at the f32 floor in every pass), solutions to 1e-6
   relative; ``bell.spmv_rows`` and one GS
   sweep at bs 1, 3 and 6 to rtol 1e-5.
15. selftest — ``test(60)``, ``test_levels(30)`` and ``test_smoothers(4)``
   on the headline preconditioner of phase 3 (seconds and K1-K3 launches
   of each): 0.05 < lmin <= lmax < 1.05, every level's bounds inside
   (0.15, 1.3), every smoother rate below 1, K1, K2 and K3 launched.
16. bf16 — the headline staged with ``dtype="bfloat16"`` (a second setup
   of the same host problem): K1 (tiled and general), K3 and K2 at its
   level shapes against their plain bf16 versions (max |err| / max |y| <=
   1e-2, in bf16), two launches to the same bits, timed like phase 4
   beside the f32 level's time (bytes at 2 per value); then the bf16 path:
   a bf16 solve of the headline from counters at 0 (it stops unconverged,
   as the JAX package's does on this lattice), which must launch the bf16
   K1, K3 and K2; then ``poisson_3d(12)`` (default options, block-ELL)
   and ``poisson_3d(24)`` (Chebyshev, DIA: K2) in bf16 on the card
   against the CPU: iterations within 10% (or 2), true relres <= 1e-8;
   and ``poisson_3d(40)`` (Chebyshev, K1 in bf16), whose pass history is
   printed beside the CPU's (neither converges).
17. frontend reference — card against CPU at small sizes: partial
   Dirichlet ``freedofs`` on ``elasticity_2d(8, length=6)``, the compound
   layout on ``vector_poisson(poisson_2d(32), 2)``, ``elmat_data`` on
   ``poisson_2d_elmats(32)``, ``nodalp2`` on ``poisson_2d(32)`` and
   ``do_test=True`` on ``poisson_3d(24)`` (Chebyshev): iterations within
   one, true relres <= 1e-8 in the external space, ``test(30)`` bounds
   within 1e-2 relative.
18. device pencils (the end of phase 11) — ``elasticity_3d(8)`` set up on the
   card by default and with ``DEVICE_SOC_MIN_EDGES = 1`` (the robust SOC
   through ``batched_la.pencil_extreme_eig`` on the card): level sizes,
   iterations, the share of aggregates that agree, the pencils whose f32
   and f64 results differ, and the time of the largest pencil batch on
   the card against the host branch (the native ``pencil_extreme_eig``;
   the default setup's robust SOC is the fused native kernel, which takes
   no pencil batch).

19. stokes — the JAX package's Stokes bench leg: ``stokes_tri(20, dim=3,
   alpha=10)`` (104,738 facet DoF) through ``StokesAMG`` with the primal
   facet -> vertex incidence (short geometric loops) and
   ``max_coarse_size`` 80 on the default device (Hiptmair smoothing on
   tile-ELL and dense levels; the tile-ELL kernel is this path's only
   hand-written one): the
   assembly, host setup, staging, the ``maxiter=8`` warm-up, the first and
   3 warm solves and the device kernels of one warm solve
   (``torch.profiler``); must give the level sizes 104,738 / 46,814 /
   19,494 / 6,461 / 1,848 / 475 / 90 / 10, at most 19 iterations (the JAX
   package takes 18), true relres <= 1e-8, every staged tensor on the
   card.
20. stokes-mac — ``stokes_mac_2d(512)`` (523,264 DoF, tree loops): its
   Hiptmair potential-space operators are DIA on five levels (13 to 65
   diagonals, offsets up to +-1,022), so K2 runs there; one warm solve
   from counters at 0 (8 levels, iterations within 5% of the JAX
   package's 409, true relres <= 1e-8, K2 launched, every staged tensor
   on the card), the device kernels of one cycle, then K2 against its
   plain version on every DIA potential-space level (max |err| / max |y|
   <= 1e-6, two launches to the same bits), timed like phase 4. Its row
   joins the kernels line (``"path": "stokes-mac"``, ``launches`` from
   the warm solve).
21. stokes reference — card against CPU: ``StokesHDivAMG`` on
   ``stokes_tri_hdiv(14)`` and ``stokes_tri_hdiv(5, dim=3)``,
   ``StokesHDGEmbeddedAMG`` on ``stokes_hdg_p1(12)``, ``StokesAMG`` on
   ``stokes_cr(10)``: the same level count, iterations within one,
   solutions to 1e-6 relative, true relres <= 1e-8.

22. dist-setup (after phase 13, on its assembled problem) —
   ``poisson_3d(101)`` with ``AMGOptions(dist_setup=8)``, SPW, Chebyshev
   on the card: the host-distributed setup (``parallel/dist_setup.py``),
   then staging and solves as in phase 12. It must give the JAX package's
   7 levels 1,000,000 / 147,697 / 39,687 / 10,660 / 2,872 / 776 / 208,
   operator complexity 2.7298, contraction decisions (3, 8, 2) and (4, 2,
   1) on ``min_rows``, shards per level 8, 8, 8, 2, 1, 1, 1, a peak shard
   state under 4/8 of the finest global bytes, iterations within one of 16,
   true relres <= 1e-8, every staged tensor on the card, and level 0 a
   full DIA whose K2 plan reads x through the read-only cache (``ldg``: its
   x window, 20,032 values, exceeds the shared-memory budget); then K2 at
   level 0 against its plain version, timed like phase 4. Its row joins
   the kernels line (``"path": "dist"``). The native calls of the setup
   and staging are checked as in phase 5, and the host setup and staging
   printed beside their numpy-branch record.
23. dist-elasticity — ``unstructured_elasticity(140, dim=2)`` (39,480
   DoF), ``dist_setup=8``, SPW, Chebyshev, ``max_coarse_size`` 60 on the
   card and on the CPU: the JAX package's levels 19,740 / 3,051 / 862 /
   242 / 67 / 18, operator complexity 2.276, its contraction decisions;
   the plain f32 defect correction on the CPU within one of the JAX
   package's 21 iterations and on the card within 10% of the CPU (each
   pass stalls at the f32 floor, as phase 14's plain elasticity solve),
   the mixed-precision PCG card against CPU within one; solutions to
   1e-6, true relres <= 1e-8.
24. mp-setup — ``mp_dist_setup_levels`` on 4 rank processes (spawned
   with the card hidden) for ``poisson_3d(41)`` (64,000 DoF) and the
   problem of phase 23: bitwise the single controller's
   ``dist_setup_levels``; the per-rank peak shard bytes, transport calls,
   moved bytes and native calls (each scalar and each elasticity rank
   must call the native kernels); then the scalar MP hierarchy staged on
   the card and solved to a true relres <= 1e-8.
25. api (after phase 16, on the headline problem) —
   ``api.h1_scal(A, coords=..., ngs_amg_sm_type="chebyshev")`` on the
   card: 6 levels (``GetNDof``), ``GetOC`` 1.762, <= 15 iterations, true
   relres <= 1e-8, K1-K3 launched in its solve (``launches_api`` in the
   kernels line); ``ToSparseMatrix`` of levels 1-5 against each level's
   device matvec (rtol 1e-5; levels 1-2 are symmetric-half), ``CINV`` on
   the coarsest level, and ``GetBF(level=2)`` raising the ValueError of
   an implicit (lattice) transfer.
26. timers — one warm headline solve with tracing on under
   ``torch.profiler``, written through ``Recorder.export_chrome``: the
   merged trace must hold ``cycle.level`` spans on the host track and K1's
   tiled kernel.
27. api reference (last) — card against CPU: ``h1_scal`` on
   ``poisson_2d(24)`` (GS) with ``GetBF``, the ``DOFMap`` transfers and
   ``ToSparseMatrix`` of every level, ``elast_3d`` on ``elasticity_3d(8)``
   with ``GetRotationOfBF`` (mixed solve), ``h1_3d`` on a 3-component
   vector Poisson, the five ``Create*`` smoothers on the ``poisson_3d(24)``
   matrix (rtol 1e-5), and ``stokes_hdiv_gg_2d``, ``stokes_hdg_gg_2d`` and
   ``stokes_gg_2d`` on phase 21's problems.

28. sharded (after phase 22, on its host levels) — the JAX package's
   multi-chip oracle (``__graft_entry__.py`` ``dryrun_multichip``) on one
   card: phase 22's host levels staged again with ``shards=8`` (plain
   tile-ELL on levels 1-3, every level padded to a multiple of 64 rows;
   checked), the hierarchy written once to ``build/sharded/`` with host
   tensors, 8 spawned gloo ranks on ``cuda:0`` each mapping it and
   keeping its rows (``parallel/sharded_run.py``), placed with
   ``shards_hint = log.shards_per_level``. Checks: 7 levels, OC 2.7298,
   placement (8, 8, 8, 2, 1, 1, 1) and ``level_shard_counts`` at or below
   it; the residual contracts over two PCG steps; the sharded PCG to 1e-5
   takes this card's replicated count (the JAX package's: 8) with rel r^2
   < 1e-10, and its x, gathered back, has a true relres (the host matrix
   in f64) below 1e-3 and at most 5% above the replicated x's (both sit at
   the f32 floor, about 1.3e-4), and lies within 1e-3 of the replicated
   x; K2 on
   the rank's window launched on every rank in that run and,
   on every rank's block of level 0, equal to its plain version (two
   launches the same bits). Prints the windowed K2's time on rank 0's
   block (graph replay, swept, one call), bytes, bound, plain version and
   cuSPARSE on the same rows, the collective rounds and bytes of a rank a
   PCG iteration, and the warm sharded solve's seconds. Its row joins the
   kernels line (``"path": "sharded"``, ``launches`` summed over ranks).
29. sharded-halo (in the same world) — the JAX tests' production cycles
   (``tests/test_parallel.py``): ``HaloTileELL`` on
   ``unstructured_poisson(100, 2, refine=1)`` (16 PCG steps), the
   ``HaloBlockELL`` cycle on ``elasticity_3d(11)`` in f64, sharded GS on
   ``unstructured_poisson(16, 2)`` (12 steps, colour-step exchanges) and
   the sub-group placement of ``poisson_3d(20)`` in f64, each against the
   replicated result on this card (1e-3, 1e-10, 1e-4, 1e-10).
30. mp-stokes (after phase 24) — ``mp_dist_stokes_levels`` and
   ``mp_dist_stokes_hdiv_levels`` on 2 numpy rank processes: equal to the
   single controller.
31. collective-transport — ``dist_setup_levels``
   (``unstructured_poisson(14, 2)``) and ``dist_stokes_levels``
   (``stokes_tri(8, 2)``), the JAX package's tests' problems, over
   ``CollectiveTransport`` on 4 gloo ranks whose words live on
   ``cuda:0``: bitwise the ``LocalTransport`` hierarchy; transport calls
   and moved bytes a rank.
32. dist-stokes (after phase 19) — ``stokes_tri(8, dim=3)`` through
   ``StokesAMG(dist_setup=8)`` against its serial setup on the card: the
   same level sizes, at most 10 iterations more, true relres <= 1e-8
   (the bench leg cannot take the distributed setup: its curl-smoothed P
   fills in, beyond the host's memory; ROADMAP section 3);
   ``stokes_tri_hdiv(14)`` through ``StokesHDivAMG(dist_setup=3)``
   against its serial setup: the same levels, P within 1e-9, at most 10
   iterations more.

Every phase prints its seconds. The last lines are the nvidia-smi line,
one JSON object describing the kernels (each row names the path its
``launches`` were counted on: ``main``, ``bf16``, ``stokes-mac``,
``dist`` or ``sharded``), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import types

import numpy as np

F32_TOL = 1e-6
F64_TOL = 1e-13
BF16_TOL = 1e-2  # bf16 kernels against their plain bf16 versions
# the block-ELL kernel against its plain version, max |err| / max |y|: a
# row sums up to ~2,000 terms in another order than torch's reduction
BELL_TOL = {"torch.float32": 1e-5, "torch.float64": 1e-12,
            "torch.bfloat16": BF16_TOL}
# the tile-ELL kernel against the plain product, max |err| / max |y|: the
# same products summed in another order (rows of up to ~270 nonzeros)
TILE_ELL_KERNEL_TOL = {"torch.float32": 1e-6, "torch.float64": 1e-14,
                       "torch.bfloat16": BF16_TOL}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM, no tensor cores; the bf16 kernels do their arithmetic in f32
PEAK_FLOP_S = {"f32": 67e12, "f64": 34e12}
HEADLINE_LEVELS = [9938375, 1259712, 157464, 19683, 2744, 343]
UNSTRUCT_DOFS = 1411632
UNSTRUCT_LEVELS = 7
UNSTRUCT_OC = 2.09  # the JAX package's operator complexity, to 2 places
UNSTRUCT_MAX_IT = 25
UNSTRUCT_FORMATS = {"TileELLStack", "TileELL", "DenseMatrix"}
# the scalar-setup and staging wrappers (and rho_power) the JAX package's
# native run reaches on the unstructured path (tests/test_torch_native.py
# holds the port's native calls equal to the JAX package's there)
UNSTRUCT_NATIVE_WRAPPERS = (
    "finest_mesh_scal", "spw_round_h1", "map_edges_agg", "edges_to_adj",
    "rho_power_h1", "smoothed_prol_scalar", "rap_csr", "csr_permute",
    "csr_sym_scale", "tile_chunk_counts", "tile_ell_fill_range",
    "tile_ell_pack", "cluster_detect", "rho_power",
)
# this phase's host setup and staging on the numpy branches of the scalar
# setup, seconds: the range of the recorded runs (PERF.md section 5)
UNSTRUCT_NUMPY_RECORD = {"setup_host_s": [45.990, 60.450],
                         "setup_staging_s": [38.8, 46.1]}
# the headline's level-0 stencil (P1 on Kuhn tetrahedra), in its order
HEADLINE_STENCIL = [
    (-1, -1, -1), (-1, -1, 0), (-1, 0, -1), (-1, 0, 0), (0, -1, -1),
    (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
    (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
]
# the main path's kernels: (source, the TPU kernel it replaces)
KERNELS = {
    "stencil_tiled3d_f32": (
        "ngsamg_tpu_torch/csrc/stencil_matvec.cu",
        "ngsamg_tpu/ops/stencil_pallas.py:38",
    ),
    "stencil_tiled3d_f64": (
        "ngsamg_tpu_torch/csrc/stencil_matvec.cu",
        "ngsamg_tpu/ops/stencil_pallas.py:38",
    ),
    "dia_sym_matvec_f32": (
        "ngsamg_tpu_torch/csrc/dia_matvec.cu",
        "ngsamg_tpu/ops/dia_pallas.py:105",
    ),
    "dia_matvec_f32": (
        "ngsamg_tpu_torch/csrc/dia_matvec.cu",
        "ngsamg_tpu/ops/dia_pallas.py:31",
    ),
}
# the bf16 path's kernels (phase 16)
BF16_KERNELS = {
    "stencil_tiled3d_bf16": KERNELS["stencil_tiled3d_f32"],
    "dia_sym_matvec_bf16": KERNELS["dia_sym_matvec_f32"],
    "dia_matvec_bf16": KERNELS["dia_matvec_f32"],
}


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _launch_counters():
    from ngsamg_tpu_torch.ops import (bell_cuda, dia_cuda, gs_cuda,
                                      stencil_cuda, tile_ell_cuda)

    return (stencil_cuda.LAUNCHES, dia_cuda.LAUNCHES, bell_cuda.LAUNCHES,
            gs_cuda.LAUNCHES, tile_ell_cuda.LAUNCHES)


def _counts():
    return {k: v for d in _launch_counters() for k, v in d.items()}


def _reset_counts():
    for d in _launch_counters():
        for k in d:
            d[k] = 0


def _bound_ms(nbytes: int, flops: int, dtype) -> tuple:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate of the dtype, whichever is larger."""
    import torch

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = PEAK_FLOP_S["f64" if dtype == torch.float64 else "f32"]
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _conv3d_call(A, x):
    """One PyTorch call computing K1's function for a 3-d stencil of reach
    1: conv3d of the lattice with a 3x3x3 weight holding the taps at
    off + 1 (cuDNN, TF32 off), zero padding 1 being the clip."""
    import torch
    import torch.nn.functional as F

    if len(A.dims) != 3 or any(abs(int(v)) > 1 for o in A.offs for v in o):
        return None
    w = torch.zeros((3, 3, 3), dtype=x.dtype, device=x.device)
    for t, o in enumerate(A.offs):
        w[o[0] + 1, o[1] + 1, o[2] + 1] += A.vals[t]
    w = w.view(1, 1, 3, 3, 3)
    xv = x[: A.nrows].view(1, 1, *A.dims)
    return lambda: F.conv3d(xv, w, padding=1)


def _csr_call(A, x):
    """One PyTorch call computing K2's/K3's function: ``torch.sparse.mm``
    (cuSPARSE) of the level as a CSR tensor built from its staged DIA data
    (explicit zeros dropped; the half storage expanded to both sides)."""
    import torch

    n = A.nrows_pad
    i = torch.arange(n, device=x.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(A.offsets):
        j = i + off
        m = (j >= 0) & (j < n) & (A.data[d] != 0)
        rows.append(i[m])
        cols.append(j[m])
        vals.append(A.data[d][m])
        if A.sym_half and off > 0:
            rows.append(j[m])
            cols.append(i[m])
            vals.append(A.data[d][m])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n),
    ).coalesce()
    csr = coo.to_sparse_csr()
    return lambda: torch.sparse.mm(csr, x)


def _rand_x(nrows, nrows_pad, dtype, seed):
    import torch

    rng = np.random.default_rng(seed)
    x = np.zeros((nrows_pad, 1))
    x[:nrows, 0] = rng.standard_normal(nrows)
    return torch.from_numpy(x).to(device="cuda", dtype=dtype)


def _check_kernel(A, x, kernel, plain, tol, label):
    """Kernel vs plain version on one input; returns the relative error."""
    import torch

    y = kernel(A, x)
    y_ref = plain(A, x)
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    scale = max(float(y_ref.abs().max()), 1e-300)
    tail = float(y[A.nrows:].abs().max()) if A.nrows < A.nrows_pad else 0.0
    rel = err / scale
    if not np.isfinite(rel) or rel > tol or tail != 0.0:
        raise AssertionError(
            f"{label}: kernel vs plain max|err|/max|y| = {rel:.3e} "
            f"(tol {tol:.0e}), pad tail max {tail}"
        )
    return err, rel


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{_nvidia_smi()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)


def phase_build():
    """Build the kernels, then check them on the CPU tests' small shapes.
    The native setup extension builds in a thread meanwhile; returns its
    future (phase 2a reads it)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ngsamg_tpu_torch import native
    from ngsamg_tpu_torch.ops import cuda_lib, dia_cuda, stencil_cuda
    from ngsamg_tpu_torch.sparse import formats

    pool = ThreadPoolExecutor(1)
    native_build = pool.submit(native.extension)
    pool.shutdown(wait=False)
    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    tile = 8192
    cube = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]
    shuffled = [cube[i] for i in np.random.default_rng(7).permutation(27)]
    for dims, offs, variant in [
        # the tiled variant: 7 taps; planes not a multiple of the tile
        ((7, 9, 11), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                      (0, -1, 0), (0, 0, 1), (0, 0, -1)], "tiled3d"),
        # the headline's 15 taps on planes of 19 x 45 cells
        ((13, 19, 45), HEADLINE_STENCIL, "tiled3d"),
        # 27 taps in shuffled order on a lattice smaller than one tile
        ((2, 3, 5), shuffled, "tiled3d"),
        # the general variant: reach 2, and a 2-d lattice
        ((5, 4, 38), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 0, 2),
                      (1, 1, -1), (-1, -1, 1)], "general"),
        ((33, 131), [(0, 0), (2, 0), (-2, 0), (0, 3), (0, -3), (1, 1),
                     (-1, -1)], "general"),
    ]:
        n = int(np.prod(dims))
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            vals = np.random.default_rng(0).standard_normal(len(offs))
            A = formats.StencilDia(
                vals=torch.as_tensor(vals, dtype=dt, device="cuda"),
                offs=tuple(offs), dims=dims, nrows=n,
                nrows_pad=-(-n // 8) * 8,
            )
            if A.launch.plan.variant != variant:
                raise AssertionError(
                    f"K1 {dims}: variant {A.launch.plan.variant}, "
                    f"expected {variant}"
                )
            key = _stencil_key(A, dt)
            before = stencil_cuda.LAUNCHES[key]
            x = _rand_x(n, A.nrows_pad, dt, 3)
            _check_kernel(A, x, stencil_cuda.stencil_matvec,
                          stencil_cuda._stencil_matvec_plain, tol,
                          f"K1 {variant} {dims} {dt}")
            if stencil_cuda.LAUNCHES[key] != before + 1:
                raise AssertionError(f"K1 {dims}: {key} did not launch")
    # the tiled launch refuses a plan that does not match its geometry
    A = formats.StencilDia(
        vals=torch.ones(15, device="cuda"), offs=tuple(HEADLINE_STENCIL),
        dims=(13, 19, 45), nrows=13 * 19 * 45, nrows_pad=13 * 19 * 45,
    )
    x = _rand_x(A.nrows, A.nrows_pad, torch.float32, 3)
    plan = A.launch.plan
    for bad in (dict(tile=(8, 32)), dict(smem_bytes=plan.smem_bytes - 4),
                dict(blocks=plan.blocks + 1)):
        wrong = types.SimpleNamespace(
            dims=A.dims, nrows=A.nrows, nrows_pad=A.nrows_pad,
            launch=dataclasses.replace(
                A.launch, plan=dataclasses.replace(plan, **bad)),
        )
        try:
            stencil_cuda._launch_tiled(wrong, x)
        except RuntimeError as e:  # cudaErrorInvalidValue from the launch
            if "launch failed with error 1" in str(e):
                continue
            raise
        raise AssertionError(f"K1 ran with a mismatched plan {bad}")
    for offsets, n, path in [
        ((-200, -128, -3, 0, 3, 128, 200), tile - 77, "smem"),
        ((-128, -1, 0, 1, 128), tile, "smem"),
        ((-300, 0, 300), 2 * tile - 5, "smem"),
        # a span whose x window exceeds the shared-memory budget
        ((-40000, -1, 0, 1, 40000), 5 * tile - 3, "ldg"),
        # more diagonals than one warp takes, rows not a multiple of 32
        (tuple(range(-60, 61, 3)), 1001, "smem"),
    ]:
        n_pad = -(-n // tile) * tile if n >= tile else -(-n // 8) * 8
        rng = np.random.default_rng(0)
        data = np.zeros((len(offsets), n_pad))
        for d, off in enumerate(offsets):
            lo, hi = max(0, -off), min(n, n - off)
            data[d, lo:hi] = rng.standard_normal(hi - lo)
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            A = formats.DiaMatrix(
                data=torch.as_tensor(data, dtype=dt, device="cuda"),
                offsets=offsets, nrows=n, nrows_pad=n_pad,
            )
            if A.launch.plan.path != path:
                raise AssertionError(
                    f"K2 {offsets}: path {A.launch.plan.path}, not {path}")
            x = _rand_x(n, n_pad, dt, 1)
            _check_kernel(A, x, dia_cuda.dia_matvec,
                          dia_cuda._dia_matvec_plain, tol,
                          f"K2 {path} {offsets} {dt}")
    # K3: every shape of plan it can select (one diagonal group or
    # several), f32 and f64
    many = tuple(range(0, 20)) + tuple(range(300, 320)) + (5000, 5001)
    for offsets, n, n_pad, variant in [
        # all tiles but the first far enough inside to skip the tests
        ((0, 1, 127, 128, 500), 40 * tile - 13, 40 * tile, "tile-r2-u2-g1"),
        # an offset larger than a tile: every tile tests its bounds
        ((0, 128, tile + 37), 3 * tile - 9, 3 * tile, "tile-r2-u2-g1"),
        # 42 diagonals on few rows: the diagonals split over groups
        (many, 20001, 20008, "tile-r2-u4-g8"),
        (many, 100001, 100008, "tile-r2-u4-g4"),
        # no main diagonal stored; a padding that is even, not more
        ((3, 64, 700), 300001, 300002, "tile-r2-u2-g1"),
    ]:
        rng = np.random.default_rng(len(offsets))
        data = np.zeros((len(offsets), n_pad))
        for d, off in enumerate(offsets):
            data[d, : n - off] = rng.standard_normal(n - off)
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            A = formats.DiaMatrix(
                data=torch.as_tensor(data, dtype=dt, device="cuda"),
                offsets=offsets, nrows=n, nrows_pad=n_pad, sym_half=True,
            )
            if _variant(A) != variant:
                raise AssertionError(
                    f"K3 {n_pad} rows {dt}: variant {_variant(A)}, "
                    f"expected {variant}")
            key = "dia_sym_matvec_" + ("f32" if dt == torch.float32 else "f64")
            before = dia_cuda.LAUNCHES[key]
            x = _rand_x(n, n_pad, dt, 1)
            _check_kernel(A, x, dia_cuda.dia_matvec,
                          dia_cuda._dia_matvec_plain, tol,
                          f"K3 {variant} {n_pad} rows {dt}")
            _same_bits(dia_cuda.dia_matvec, A, x, f"K3 {variant}")
            if dia_cuda.LAUNCHES[key] != before + 1 + 2:
                raise AssertionError(f"K3 {variant}: {key} did not launch")
    # K3's launch refuses a plan that does not match the kernel's layout
    plan = A.launch.plan
    for bad in (dict(tile=plan.tile // 2), dict(batch=8),
                dict(smem_bytes=plan.smem_bytes + 8),
                dict(blocks=plan.blocks + 1)):
        wrong = types.SimpleNamespace(
            data=A.data, offsets=A.offsets, nrows=A.nrows,
            nrows_pad=A.nrows_pad, sym_half=True,
            launch=dataclasses.replace(
                A.launch, plan=dataclasses.replace(plan, **bad)),
        )
        try:
            dia_cuda.dia_matvec(wrong, x)
        except RuntimeError as e:  # cudaErrorInvalidValue from the launch
            if "launch failed with error 1" in str(e):
                continue
            raise
        raise AssertionError(f"K3 ran with a mismatched plan {bad}")
    _bell_build_checks()
    _gs_build_checks()
    _tile_ell_build_checks()
    print("[build] small-shape kernel checks passed", flush=True)
    return native_build


def _random_block_ell(br, bc, nbr, kmax, chunk, seed, device):
    """A random block-sparse matrix packed as a BlockELL on ``device``: 0
    to kmax blocks a row (row 1 empty), nbr block rows and columns."""
    import scipy.sparse as sp

    from ngsamg_tpu_torch.sparse import bell

    rng = np.random.default_rng(seed)
    deg = rng.integers(0, kmax + 1, nbr)
    deg[1] = 0
    cols = [np.sort(rng.choice(nbr, size=k, replace=False)) for k in deg]
    indptr = np.concatenate([[0], np.cumsum(deg)])
    data = rng.standard_normal((int(deg.sum()), br, bc))
    A = sp.bsr_matrix((data, np.concatenate(cols).astype(np.int32), indptr),
                      shape=(nbr * br, nbr * bc))
    return bell.from_scipy(A, br, bc, dtype=np.float64, col_chunk=chunk,
                           device=device)


def _bell_build_checks():
    """The block-ELL kernel against its plain version on random operators:
    every staged block shape (br, bc in {1, 2, 3, 6}) and two generic ones
    (4x4, and 6x6 with col_chunk 2), f32, f64 and bf16 (held to the f32
    plain version of the same bf16 values: the kernel rounds each product
    and the sum to bf16),
    with the row counts and without them (every slot read), the own plan
    and forced ones (1 lane, 32 lanes, 32 lanes in 4 warps); two launches
    give the same bits, and the launch refuses a plan that does not match
    the kernel's layout."""
    import torch

    from ngsamg_tpu_torch.ops import bell_cuda
    from ngsamg_tpu_torch.sparse import bell

    shapes = [(br, bc, 1) for br in (1, 2, 3, 6) for bc in (1, 2, 3, 6)]
    shapes += [(4, 4, 1), (6, 6, 2), (3, 3, 2)]
    for br, bc, chunk in shapes:
        # an odd row count (x's rows must be a multiple of col_chunk)
        for nbr, kmax in ((1000 + (chunk == 1), 9), (300, 160)):
            T64 = _random_block_ell(br, bc, nbr, kmax, chunk,
                                    7 * br + bc + nbr, "cuda")
            for dt in (torch.float32, torch.float64, torch.bfloat16):
                T = dataclasses.replace(T64, data=T64.data.to(dt))
                bare = dataclasses.replace(T, nslots=None)
                n, K, _, bcw = T.data.shape
                plans = [None, bell_cuda.bell_plan(K, br, bcw, n, lanes=1),
                         bell_cuda.bell_plan(K, br, bcw, n, lanes=32)]
                if T.launch.staged:
                    plans.append(
                        bell_cuda.bell_plan(K, br, bcw, n, lanes=32, warps=4))
                x = torch.randn((nbr, bc), dtype=torch.float64,
                                device="cuda").to(dt)
                ref = bell._spmv_plain(
                    dataclasses.replace(T, data=T.data.float()), x.float())
                for A in (T, bare):
                    for plan in plans:
                        label = (f"block-ELL {br}x{bc} c{chunk} {nbr} rows "
                                 f"{dt} {(plan or A.launch).variant} "
                                 f"nslots={A.nslots is not None}")
                        key = "bell_matvec_" + {
                            torch.float32: "f32", torch.float64: "f64",
                            torch.bfloat16: "bf16"}[dt]
                        before = bell_cuda.LAUNCHES[key]
                        run = (lambda A, x, plan=plan:
                               bell_cuda.bell_matvec(A, x, plan=plan))
                        if dt == torch.bfloat16:
                            y = run(A, x).float()
                            err = float((y - ref).abs().max()
                                        / ref.abs().max())
                            if err > BF16_TOL or y[A.nrows:].any():
                                raise AssertionError(f"{label}: {err:.3e}")
                        else:
                            _check_kernel(A, x, run, bell._spmv_plain,
                                          BELL_TOL[str(dt)], label)
                        _same_bits(run, A, x, label)
                        if bell_cuda.LAUNCHES[key] != before + 3:
                            raise AssertionError(f"{label}: did not launch")
    # the launch refuses a plan that does not match the kernel's layout
    T = _random_block_ell(3, 3, 1001, 9, 1, 0, "cuda")
    G = _random_block_ell(6, 6, 300, 20, 2, 0, "cuda")
    x3 = torch.randn((1001, 3), dtype=torch.float64, device="cuda")
    x6 = torch.randn((300, 6), dtype=torch.float64, device="cuda")
    plan = T.launch
    for A, x, bad in (
            (T, x3, dataclasses.replace(plan, blocks=plan.blocks + 1)),
            (T, x3, dataclasses.replace(plan, lanes=3)),
            (T, x3, bell_cuda.BellPlan(lanes=16, warps=2, blocks=plan.blocks,
                                       staged=True)),
            (G, x6, bell_cuda.BellPlan(lanes=32, warps=2,
                                       blocks=-(-300 // 4), staged=False))):
        try:
            bell_cuda.bell_matvec(A, x, plan=bad)
        except RuntimeError as e:  # cudaErrorInvalidValue from the launch
            if "launch failed with error 1" in str(e):
                continue
            raise
        raise AssertionError(f"block-ELL ran with a mismatched plan {bad}")
    print("[build] block-ELL kernel checks passed", flush=True)


def _data_as(T, dtype):
    """A tile-ELL operator with its values cast to ``dtype``."""
    from ngsamg_tpu_torch.sparse import formats

    if isinstance(T, formats.TileELLStack):
        return dataclasses.replace(T, blocks=tuple(
            dataclasses.replace(b, data=b.data.to(dtype)) for b in T.blocks))
    return dataclasses.replace(T, data=T.data.to(dtype))


def _tile_ell_key(T) -> str:
    from ngsamg_tpu_torch.ops import cuda_lib

    return "tile_ell_matvec_" + cuda_lib.suffix(T.launch.vals.dtype)


def _tile_ell_build_checks():
    """The tile-ELL kernel against the plain product on random operators
    of the packers: a square stack of three buckets (chunk 8; rows of ~12
    to ~200 nonzeros) and a rectangular chunk-1 transfer with padded rows
    and columns, both with explicit zeros, in f32, f64 and bf16 (the bf16
    cast of the f32 operators, held to the f32 plain product of the same
    bf16 values), on the operator's own plan and on every lane count; two
    launches give the same bits, and the launch refuses a plan that does
    not match the kernel's layout."""
    import scipy.sparse as sp
    import torch

    from ngsamg_tpu_torch.ops import tile_ell_cuda
    from ngsamg_tpu_torch.precond.amg import _cast_floats, _full_f32
    from ngsamg_tpu_torch.sparse import formats

    rng = np.random.default_rng(11)

    def banded(n, m, widths):
        rows, cols = [], []
        for r in range(n):
            w = widths[min(r * len(widths) // n, len(widths) - 1)]
            c = np.unique(np.clip(
                r * m // n + rng.integers(-w, w + 1, max(w // 2, 1)),
                0, m - 1))
            rows += [r] * len(c)
            cols += list(c)
        vals = rng.standard_normal(len(rows))
        vals[rng.random(len(rows)) < 0.05] = 0.0
        return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))

    square = banded(12_293, 12_293, [400, 120, 24])
    rect = banded(3_001, 997, [40, 3])
    checked = 0
    for dt in (np.float32, np.float64):
        ops = [formats.tile_ell_stack_from_scipy(square, dt, device="cuda"),
               formats.tile_ell_from_scipy(rect, dt, nr_pad=3_008,
                                           nc_pad=1_000, device="cuda")]
        if len(ops[0].blocks) < 2:
            raise AssertionError("tile-ELL build check: one bucket")
        if dt == np.float32:
            ops += [_cast_floats(T, torch.bfloat16, {}) for T in ops]
        for T in ops:
            L = T.launch
            x = torch.randn((T.ncols_pad, 1), dtype=torch.float64,
                            device="cuda").to(L.vals.dtype)
            plans = [None] + [
                tile_ell_cuda.tile_ell_plan(L.n_tiles, L.mean, L.longest,
                                            lanes=k)
                for k in (1, 2, 4, 8, 16, 32)]
            with _full_f32():
                if x.dtype == torch.bfloat16:
                    ref = _data_as(T, torch.float32).product(x.float())
                else:
                    ref = T.product(x)
            for plan in plans:
                label = (f"tile-ELL {type(T).__name__} {T.nrows} rows "
                         f"{L.vals.dtype} {(plan or L.plan).variant}")
                key = _tile_ell_key(T)
                before = tile_ell_cuda.LAUNCHES[key]

                def run(A, v, plan=plan):
                    return tile_ell_cuda.tile_ell_matvec(A, v, plan=plan)

                y = run(T, x).double()
                err = float((y - ref.double()).abs().max()
                            / ref.double().abs().max())
                tol = TILE_ELL_KERNEL_TOL[str(L.vals.dtype)]
                if not err <= tol or y[T.nrows:].any():
                    raise AssertionError(f"{label}: {err:.3e} (tol {tol})")
                _same_bits(run, T, x, label)
                if tile_ell_cuda.LAUNCHES[key] != before + 3:
                    raise AssertionError(f"{label}: did not launch")
                checked += 1
    T = formats.tile_ell_from_scipy(rect, np.float32, device="cuda")
    x = torch.randn((T.ncols_pad, 1), device="cuda")
    plan = T.launch.plan
    for bad in (dataclasses.replace(plan, blocks=plan.blocks + 1),
                dataclasses.replace(plan, lanes=3),
                dataclasses.replace(plan, lanes=64),
                dataclasses.replace(plan, threads=32),
                dataclasses.replace(plan, lanes=16, threads=64)):
        try:
            tile_ell_cuda.tile_ell_matvec(T, x, plan=bad)
        except RuntimeError as e:  # cudaErrorInvalidValue from the launch
            if "launch failed with error 1" in str(e):
                continue
            raise
        raise AssertionError(f"tile-ELL ran with a mismatched plan {bad}")
    print(f"[build] tile-ELL kernel checks passed ({checked} cases)",
          flush=True)


def _gs_level(nb, bs, seed, dtype):
    """A random colour-sorted level of ``nb`` block rows on the card: its
    block-ELL operator and its GS smoother, staged with a launch plan as
    the hierarchy stages them (bf16: cast from f32 on the card)."""
    import torch

    from ngsamg_tpu_torch.precond.amg import _cast_floats
    from ngsamg_tpu_torch.smoothers import build
    from ngsamg_tpu_torch.sparse import bell

    opts = _options().smoother
    A = _random_spd_bsr(nb, bs, seed)
    perm, cb = build.plan_row_order(A, bs, opts, 0)
    sperm = (perm[:, None] * bs + np.arange(bs)).ravel()
    A = A[sperm][:, sperm].tocsr()
    npdt = np.float64 if dtype == torch.float64 else np.float32
    data, cols, nbr, nslots = bell.pack(A, bs, bs, npdt, 8)
    T = bell.from_packed(data, cols, nbr, nbr, device="cuda", nslots=nslots)
    sm = build.stage_smoother(
        build.build_smoother(A, bs, opts, 0, data.shape[0], npdt,
                             color_bounds=cb, ell=(data, cols)),
        "cuda", A=T)
    if dtype == torch.bfloat16:
        T, sm = _cast_floats((T, sm), torch.bfloat16, {})
    return T, sm


def _gs_build_checks():
    """The GS sweep kernel against its plain version on the card
    (``core.gs_plain`` of the same smoother) on random colour-sorted levels
    of 3,001 and 301
    block rows: bs 1, 2, 3 and 6, f32, f64 and bf16 (the plain bf16 sweep
    rounds where the kernel does), on its own plan and on forced plans of
    both launch shapes (one lane a row, four warps a row; one CTA with
    fewer groups than a colour's rows, two CTAs, four of one warp,
    sixteen), forward and
    backward, one and two steps, from zero and from a nonzero x. The
    caller's x is not written, two launches give the same bits, each call
    counts its launches, a level staged for the kernel carries no split
    copies, a smoother with no plan raises on a level the kernel takes, and
    the launch refuses a plan that does not match the kernels."""
    import torch

    from ngsamg_tpu_torch.ops import cuda_lib, gs_cuda
    from ngsamg_tpu_torch.smoothers import core

    checked = 0
    for bs in (1, 2, 3, 6):
        for nb in (3001, 301):
            for dt in (torch.float32, torch.float64, torch.bfloat16):
                T, sm = _gs_level(nb, bs, 40 + nb % 7 + bs, dt)
                n, K = T.cols.shape
                item = T.data.element_size()
                g = torch.Generator(device="cuda").manual_seed(nb + bs)
                x = torch.zeros((n, bs), dtype=torch.float64, device="cuda")
                b = torch.zeros_like(x)
                x[:T.nrows] = torch.randn((T.nrows, bs), generator=g,
                                          device="cuda", dtype=torch.float64)
                b[:T.nrows] = torch.randn((T.nrows, bs), generator=g,
                                          device="cuda", dtype=torch.float64)
                x, b = x.to(dt), b.to(dt)
                args = (n, bs, item, sm.color_bounds, K)
                threads = gs_cuda.SWEEP_THREADS[bs]
                plans = [sm.launch,
                         gs_cuda.gs_plan(*args, route="colour"),
                         gs_cuda.gs_plan(*args, route="colour", lanes=1),
                         gs_cuda.gs_plan(*args, route="colour", lanes=32,
                                         warps=4),
                         gs_cuda.gs_plan(*args, route="sweep"),
                         gs_cuda.gs_plan(*args, route="sweep", cluster=1,
                                         threads=threads, tpr=threads // 2),
                         gs_cuda.gs_plan(*args, route="sweep", cluster=4,
                                         threads=32, tpr=8),
                         gs_cuda.gs_plan(*args, route="sweep", cluster=2,
                                         tpr=8),
                         gs_cuda.gs_plan(*args, route="sweep", cluster=16)]
                tol = BELL_TOL[str(dt)]
                assert sm.cdata == sm.ccols == sm.cdinv == ()
                try:
                    core.smooth(dataclasses.replace(sm, ell_width=0), T,
                                None, b)
                except ValueError as e:
                    assert "no launch plan" in str(e), e
                else:
                    raise AssertionError("GS ran a level the kernel takes "
                                         "without a plan")
                for steps in (1, 2):
                    ssm = dataclasses.replace(sm, steps=steps)
                    assert ssm.launch is not None
                    for reverse in (False, True):
                        for x0 in (None, x):
                            ref = core.gs_plain(ssm, T, x0, b,
                                                reverse=reverse).float()
                            scale = max(float(ref.abs().max()), 1e-30)
                            for plan in plans:
                                label = (f"GS bs {bs} {nb} rows {dt} "
                                         f"{plan.variant} steps {steps} "
                                         f"reverse {reverse} "
                                         f"zero {x0 is None}")
                                key = (f"gs_{plan.route}_"
                                       f"{cuda_lib.suffix(dt)}")
                                before = gs_cuda.LAUNCHES[key]
                                kept = None if x0 is None else x0.clone()
                                y = gs_cuda.gs_sweep(ssm, T, x0, b,
                                                     reverse=reverse,
                                                     plan=plan)
                                y2 = gs_cuda.gs_sweep(ssm, T, x0, b,
                                                      reverse=reverse,
                                                      plan=plan)
                                torch.cuda.synchronize()
                                err = float((y.float() - ref).abs().max()
                                            / scale)
                                if not np.isfinite(err) or err > tol:
                                    raise AssertionError(
                                        f"{label}: {err:.3e} (tol {tol})")
                                if not torch.equal(y, y2):
                                    raise AssertionError(
                                        f"{label}: two launches differ")
                                if kept is not None and not torch.equal(
                                        kept, x0):
                                    raise AssertionError(
                                        f"{label}: x was written")
                                per = (1 if plan.route == "sweep" else
                                       (len(sm.color_bounds) - 1) * steps)
                                if gs_cuda.LAUNCHES[key] != before + 2 * per:
                                    raise AssertionError(
                                        f"{label}: launches not counted")
                                checked += 1
    # the launch refuses a plan that does not match the kernels' layout
    T, sm = _gs_level(301, 3, 0, torch.float32)
    b = torch.ones((T.nrows_pad, 3), device="cuda")
    p = sm.launch
    for bad in (dataclasses.replace(p, route="sweep", cluster=17),
                dataclasses.replace(p, route="sweep", lanes=2, warps=1),
                dataclasses.replace(p, route="sweep", threads=2048),
                dataclasses.replace(p, route="sweep", cluster=1, threads=96,
                                    lanes=32, warps=2),
                dataclasses.replace(p, route="colour", lanes=16, warps=2),
                dataclasses.replace(p, route="colour", lanes=3, warps=1)):
        try:
            gs_cuda.gs_sweep(sm, T, None, b, reverse=False, plan=bad)
        except RuntimeError as e:  # cudaErrorInvalidValue from the launch
            if "launch failed with error 1" in str(e):
                continue
            raise
        raise AssertionError(f"GS ran with a mismatched plan {bad}")
    print(f"[build] GS sweep kernel checks passed ({checked} cases)",
          flush=True)


def phase_native(native_build):
    """The native setup extension: its build, and each block-setup wrapper
    against its numpy branch on the finest level of a 3D elasticity
    problem."""
    import os
    import sysconfig

    from ngsamg_tpu_torch import native
    from ngsamg_tpu_torch.native import build, parity
    from ngsamg_tpu_torch.utils import fem

    t0 = time.perf_counter()
    ext = native_build.result()  # a failed build raises here
    include = sysconfig.get_paths()["include"]
    gxx = subprocess.run([build.CXX, "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    p = fem.unstructured_elasticity(NATIVE_N, dim=3, refine=1)
    rows = parity.block_setup_parity(p.A, p.coords, 3)
    q = fem.unstructured_poisson(NATIVE_SCALAR_N, dim=3, refine=1)
    t1 = time.perf_counter()
    scalar_rows = parity.scalar_setup_parity(q.A, q.coords)
    out = {
        "build_s": native.build_seconds,
        "library": os.path.relpath(ext.__file__),
        "gxx": gxx,
        "python_h": os.path.exists(os.path.join(include, "Python.h")),
        "python_include": include,
        "dofs": int(p.n),
        "wrappers": rows,
        "scalar_dofs": int(q.n),
        "scalar_wrappers": scalar_rows,
        "scalar_s": time.perf_counter() - t1,
        "s": time.perf_counter() - t0,
    }
    print("[native] " + json.dumps(out), flush=True)
    bad = [r["wrapper"] for r in rows if not r["ok"] or r["tol"] > 1e-8]
    bad += [r["wrapper"] for r in scalar_rows
            if not r["ok"] or r["tol"] > 1e-10]
    if bad or len(rows) != len(parity.TOLERANCES) or len(scalar_rows) != len(
            parity.SCALAR_TOLERANCES):
        raise AssertionError(f"native: wrappers off their numpy branch: {bad}")
    if len(rows) + len(scalar_rows) != len(native.WRAPPERS):
        raise AssertionError("native: not every wrapper was held")
    return out


def _native_calls() -> dict:
    """The native setup calls counted since the last reset, per wrapper."""
    from ngsamg_tpu_torch import native

    return {k: dict(v) for k, v in native.CALLS.items()
            if v["native"] or v["declined"]}


def _check_native(label, calls, wrappers):
    """Each wrapper of ``wrappers`` must have been called natively."""
    missing = [k for k in wrappers
               if calls.get(k, {}).get("native", 0) == 0]
    if missing:
        raise AssertionError(f"{label}: no native call of {missing} in the "
                             f"setup: {calls}")


def phase_main_path():
    import torch

    from ngsamg_tpu_torch import AMGOptions, AMGPreconditioner
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType
    from ngsamg_tpu_torch.utils import fem

    _reset_counts()
    t0 = time.perf_counter()
    p = fem.poisson_3d(216)
    t1 = time.perf_counter()
    opts = AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
    pc = AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cuda"
    ).setup()
    t2 = time.perf_counter()
    x, info = pc.solve(p.b, tol=1e-8, return_device=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _counts()

    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and tuple(x.shape) == (p.n,) and x.dtype == torch.float64):
        raise AssertionError(f"solution: {type(x)} {getattr(x, 'shape', '')}")
    xh = x.cpu().numpy()
    if not np.isfinite(xh).all():
        raise AssertionError("solution is not finite")
    relres = float(np.linalg.norm(p.b - p.A @ xh) / np.linalg.norm(p.b))
    sizes = [int(v) for v in pc.log_.nvs]
    out = {
        "dofs": int(p.n),
        "assembly_s": t1 - t0,
        "setup_s": t2 - t1,
        "setup_host_s": pc.setup_time_host,
        "setup_staging_s": pc.setup_time_device,
        "solve_s": t3 - t2,
        "iterations": int(info.iterations),
        "outer_iterations": int(info.outer_iterations),
        "relres_true": relres,
        "relres_device": float(info.relres),
        "num_levels": pc.num_levels,
        "operator_complexity": pc.operator_complexity,
        "level_sizes": sizes,
        "launches": launches,
    }
    print("[main] " + json.dumps(out), flush=True)
    if pc.num_levels != 6:
        raise AssertionError(f"num_levels {pc.num_levels} != 6")
    if round(pc.operator_complexity, 3) != 1.762:
        raise AssertionError(f"operator complexity {pc.operator_complexity}")
    if sizes != HEADLINE_LEVELS:
        raise AssertionError(f"level sizes {sizes}")
    if int(info.iterations) > 15:
        raise AssertionError(f"{info.iterations} iterations > 15")
    if not info.converged or relres > 1e-8:
        raise AssertionError(
            f"not converged: device relres {info.relres}, true {relres}"
        )
    on_path = _path_kernels(pc)
    if on_path != set(KERNELS):
        raise AssertionError(f"headline hierarchy runs {sorted(on_path)}")
    for k in sorted(on_path):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    return p, pc, out


def _stencil_key(A, dtype) -> str:
    """The launch counter of the K1 variant that A's plan picks."""
    from ngsamg_tpu_torch.ops import cuda_lib

    kind = ("stencil_tiled3d" if A.launch.plan.variant == "tiled3d"
            else "stencil_matvec")
    return f"{kind}_{cuda_lib.suffix(dtype)}"


def _path_kernels(pc) -> set:
    """The kernels the staged hierarchy's matvecs dispatch to."""
    import torch

    from ngsamg_tpu_torch.ops import cuda_lib
    from ngsamg_tpu_torch.sparse import bell, formats

    names = set()
    for lev in pc.op.levels:
        if isinstance(lev.A, formats.StencilDia):
            names.add(_stencil_key(lev.A, torch.float32))
        elif isinstance(lev.A, formats.DiaMatrix):
            names.add("dia_sym_matvec_f32" if lev.A.sym_half
                      else "dia_matvec_f32")
        elif isinstance(lev.A, bell.BlockELL):
            names.add("bell_matvec_" + cuda_lib.suffix(lev.A.data.dtype))
    if isinstance(pc._A64_dev, formats.StencilDia):
        names.add(_stencil_key(pc._A64_dev, torch.float64))
    if any(isinstance(t, bell.BlockELL) for t in (pc._A64_dev,
                                                   pc._A64_mixed)):
        names.add("bell_matvec_f64")
    tile = (formats.TileELL, formats.TileELLStack)
    if any(isinstance(T, tile) for lev in pc.op.levels
           for T in (lev.A, lev.P, lev.R)):
        names.add("tile_ell_matvec_f32")
    if any(isinstance(t, tile) for t in (pc._A64_dev, pc._A64_mixed)):
        names.add("tile_ell_matvec_f64")
    return names


def _level_cost(A, dtype) -> tuple:
    """(bytes, flops) one matvec must move and do: each input read once
    (x, the values or the DIA data, the offsets), y written once; two
    operations per stored nonzero that this level's data holds. Of the DIA
    data only the entries whose row and column both lie in [0, nrows)
    count: a matvec never reads the storage's out-of-range slots."""
    import torch

    es = torch.empty((), dtype=dtype).element_size()
    vec = 2 * A.nrows_pad * es
    if hasattr(A, "dims"):
        nnz = sum(
            int(np.prod([max(0, n - abs(int(o[k])))
                         for k, n in enumerate(A.dims)]))
            for o in A.offs
        )
        return vec + len(A.offs) * es, 2 * nnz
    nz = int((A.data != 0).sum())
    if A.sym_half:
        nz = 2 * nz - int((A.data[A.offsets.index(0)] != 0).sum()) \
            if 0 in A.offsets else 2 * nz
    used = sum(max(0, A.nrows - abs(int(o))) for o in A.offsets)
    return vec + used * es + 8 * len(A.offsets), 2 * nz


def _variant(A) -> str:
    """Which kernel design a level's launch takes."""
    from ngsamg_tpu_torch.ops import dia_cuda

    plan = A.launch.plan
    if isinstance(plan, dia_cuda.DiaPlan):
        return f"split-{plan.path}"
    return plan.variant  # K1's and K3's plans name theirs


def _same_bits(kernel, A, x, label):
    """Two launches on the same input give the same bits."""
    import torch

    y1, y2 = kernel(A, x), kernel(A, x)
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError(f"{label}: two launches differ")


def _build_row_kernel():
    """Build and load ``csrc/probes/dia_sym_row.cu``: the one-thread-per-row
    K3 that the tiled one replaced. The package does not build it."""
    import ctypes

    from ngsamg_tpu_torch.ops import cuda_lib

    src = cuda_lib.CSRC / "probes" / "dia_sym_row.cu"
    out = cuda_lib.build().parent / "libdia_sym_row.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(out)).ngsamg_dia_sym_row_f32
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_int, ctypes.c_longlong, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def _row_kernel(fn, A, x):
    """One launch of the row kernel on a staged level: the before number."""
    import torch

    from ngsamg_tpu_torch.ops import cuda_lib

    y = torch.empty_like(x)

    def run():
        rc = fn(A.data.data_ptr(), A.launch.offs.data_ptr(), len(A.offsets),
                A.nrows_pad, x.data_ptr(), y.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        cuda_lib.check(rc, "dia_sym_row")
        return y

    return run


def phase_kernels(p, pc, launches):
    """Each kernel vs its plain version on the staged main-path levels,
    with its device time per launch (CUDA-graph replay), its single-call
    time, its bound, and the time of one PyTorch call for the same
    function (conv3d or cuSPARSE, a yardstick the port never calls)."""
    import torch

    from ngsamg_tpu_torch.ops import dia_cuda, stencil_cuda
    from ngsamg_tpu_torch.sparse import formats
    from ngsamg_tpu_torch.utils.timing import cold_ms, event_ms, graph_ms

    cases = []  # (kernel name, level, A, dtype)
    for lvl, lev in enumerate(pc.op.levels):
        A = lev.A
        if isinstance(A, formats.StencilDia):
            cases.append((_stencil_key(A, torch.float32), lvl, A,
                          torch.float32))
            cases.append((_stencil_key(pc._A64_dev, torch.float64), lvl,
                          pc._A64_dev, torch.float64))
        elif isinstance(A, formats.DiaMatrix):
            name = "dia_sym_matvec_f32" if A.sym_half else "dia_matvec_f32"
            cases.append((name, lvl, A, torch.float32))
    per_kernel = {}
    row_fn = _build_row_kernel()
    for name, lvl, A, dt in cases:
        if name.startswith("stencil"):
            kern, plain = stencil_cuda.stencil_matvec, \
                stencil_cuda._stencil_matvec_plain
            library = _conv3d_call
        else:
            kern, plain = dia_cuda.dia_matvec, dia_cuda._dia_matvec_plain
            library = _csr_call
        tol = F32_TOL if dt == torch.float32 else F64_TOL
        x = _rand_x(A.nrows, A.nrows_pad, dt, 100 + lvl)
        err, rel = _check_kernel(A, x, kern, plain, tol, f"{name} level {lvl}")
        _same_bits(kern, A, x, f"{name} level {lvl}")
        nbytes, flops = _level_cost(A, dt)
        bound_ms, bound_by = _bound_ms(nbytes, flops, dt)
        entry = {
            "level": lvl, "rows": A.nrows,
            "terms": len(getattr(A, "offsets", None) or A.offs),
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "rel_err": rel,
            "device_ms": graph_ms(lambda: kern(A, x)),
            "cold_ms": cold_ms(lambda: kern(A, x)),
            "call_ms": event_ms(lambda: kern(A, x)),
            "plain_ms": graph_ms(lambda: plain(A, x), n=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        lib = library(A, x)
        entry["library_ms"] = None if lib is None else graph_ms(lib)
        entry["share_of_bound"] = bound_ms / entry["device_ms"]
        del lib
        entry["variant"] = _variant(A)
        if name.startswith("dia_sym"):
            old = _row_kernel(row_fn, A, x)
            entry["old_max_abs_err"], _ = _check_kernel(
                A, x, lambda A_, x_: old(), plain, tol,
                f"{name} row kernel, level {lvl}")
            entry["old_ms"] = graph_ms(old)
            entry["old_cold_ms"] = cold_ms(old)
        if entry["variant"] == "tiled3d":
            # the general kernel on the same level: the before number
            meta = stencil_cuda._device_meta(A.offs, A.dims, x.device)

            def general():
                return stencil_cuda._launch_general(A, x, meta)

            entry["general_max_abs_err"], _ = _check_kernel(
                A, x, lambda A_, x_: general(), plain, tol,
                f"{name} general kernel, level {lvl}")
            entry["general_ms"] = graph_ms(general)
        print(f"[kernels] {name} " + json.dumps(entry), flush=True)
        per_kernel.setdefault(name, []).append(entry)
    rows = []
    for name, (src, replaces) in KERNELS.items():
        levels = per_kernel[name]
        big = max(levels, key=lambda e: e["rows"])
        rows.append({
            "name": name, "path": "main", "route": "cuda", "source": src,
            "replaces": replaces, "launches": int(launches[name]),
            "max_abs_err": max(e["max_abs_err"] for e in levels),
            "ms": big["device_ms"], "device_ms": big["device_ms"],
            "cold_ms": big["cold_ms"], "call_ms": big["call_ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big["library_ms"],
            "variant": big["variant"],
            "levels": [
                {k: e[k] for k in ("level", "rows", "variant", "device_ms",
                                   "cold_ms", "call_ms", "bound_ms",
                                   "share_of_bound", "library_ms", "plain_ms",
                                   "general_ms", "old_ms", "old_cold_ms")
                 if k in e}
                for e in levels
            ],
        })
    return rows


def phase_reference(p, pc):
    """Five warm solves (the first one's launches counted); a small solve
    on the card vs the CPU."""
    import torch

    from ngsamg_tpu_torch import AMGOptions, AMGPreconditioner
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType
    from ngsamg_tpu_torch.utils import fem

    walls = []
    for k in range(5):
        if k == 0:
            _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = pc.solve(p.b, tol=1e-8, return_device=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if k == 0:
            warm_launches = _counts()
    warm = float(np.median(walls))
    print(f"[reference] warm solves {json.dumps(walls)} s, median "
          f"{warm:.4f} s, {info.iterations} iterations, relres "
          f"{info.relres:.3e}, launches of one {json.dumps(warm_launches)}",
          flush=True)

    q = fem.poisson_3d(40)
    opts = AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
    sols = {}
    for dev in ("cuda", "cpu"):
        pcs = AMGPreconditioner(q.A, coords=q.coords, options=opts,
                                device=dev).setup()
        xs, inf = pcs.solve(q.b, tol=1e-8)
        sols[dev] = (xs, inf)
    (xg, ig), (xc, ic) = sols["cuda"], sols["cpu"]
    diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
    print(f"[reference] poisson_3d(40): card {ig.iterations} it relres "
          f"{ig.relres:.3e}; cpu {ic.iterations} it relres {ic.relres:.3e}; "
          f"|x_card - x_cpu|/|x_cpu| {diff:.3e}", flush=True)
    if abs(ig.iterations - ic.iterations) > 1 or not ig.converged:
        raise AssertionError("small solve on the card disagrees with the CPU")
    if diff > 1e-6:
        raise AssertionError(f"small solve differs from the CPU by {diff}")
    return warm, warm_launches


def _cheb_opts():
    from ngsamg_tpu_torch import AMGOptions
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType

    return AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))


def phase_unstructured():
    """The unstructured path at 1,411,632 DoF on the card."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner, native
    from ngsamg_tpu_torch.utils import fem

    _reset_counts()
    t0 = time.perf_counter()
    p = fem.unstructured_poisson(55, dim=3, refine=1)
    t1 = time.perf_counter()
    native.reset_calls()
    pc = AMGPreconditioner(
        p.A, coords=p.coords, options=_cheb_opts(), device="cuda"
    ).setup()
    t2 = time.perf_counter()
    native_calls = _native_calls()
    x, info = pc.solve(p.b, tol=1e-8, return_device=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _counts()
    # the f64 defect correction runs on the finest level's f64 twin on the
    # card, so the answer stays there
    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and x.dtype == torch.float64):
        raise AssertionError(f"solution: {type(x)}, not an f64 CUDA tensor")
    x = x.cpu().numpy()
    if x.shape != (p.n,) or not np.isfinite(x).all():
        raise AssertionError(f"solution: shape {x.shape}, not all finite")
    relres = float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))
    t4 = time.perf_counter()
    _x2, info2 = pc.solve(p.b, tol=1e-8)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t4
    cc = pc.op.cluster_corr
    level_fmts = [type(lev.A).__name__ for lev in pc.op.levels]
    transfer_fmts = [
        [type(lev.P).__name__, type(lev.R).__name__]
        for lev in pc.op.levels[:-1]
    ]
    out = {
        "dofs": int(p.n),
        "assembly_s": t1 - t0,
        "setup_s": t2 - t1,
        "setup_host_s": pc.setup_time_host,
        "setup_staging_s": pc.setup_time_device,
        "setup_numpy_record": UNSTRUCT_NUMPY_RECORD,
        "card": _nvidia_smi(),
        "native_calls": native_calls,
        "solve_s": t3 - t2,
        "warm_solve_s": warm,
        "iterations": int(info.iterations),
        "outer_iterations": int(info.outer_iterations),
        "warm_iterations": int(info2.iterations),
        "relres_true": relres,
        "relres_solver": float(info.relres),
        "num_levels": pc.num_levels,
        "operator_complexity": pc.operator_complexity,
        "level_sizes": [int(v) for v in pc.log_.nvs],
        "level_formats": level_fmts,
        "transfer_formats": transfer_fmts,
        "clusters": None if cc is None else list(cc.idx.shape),
        "launches": launches,
    }
    print("[unstructured] " + json.dumps(out), flush=True)
    if int(p.n) != UNSTRUCT_DOFS:
        raise AssertionError(f"{p.n} DoF != {UNSTRUCT_DOFS}")
    if pc.num_levels != UNSTRUCT_LEVELS:
        raise AssertionError(f"num_levels {pc.num_levels} != {UNSTRUCT_LEVELS}")
    if round(pc.operator_complexity, 2) != UNSTRUCT_OC:
        raise AssertionError(f"operator complexity {pc.operator_complexity}")
    if int(info.iterations) > UNSTRUCT_MAX_IT:
        raise AssertionError(f"{info.iterations} iterations > {UNSTRUCT_MAX_IT}")
    if not info.converged or relres > 1e-8:
        raise AssertionError(
            f"not converged: solver relres {info.relres}, true {relres}"
        )
    bad = {f for f in level_fmts + sum(transfer_fmts, [])
           if f not in UNSTRUCT_FORMATS}
    if bad:
        raise AssertionError(f"formats outside {UNSTRUCT_FORMATS}: {bad}")
    if cc is None:
        raise AssertionError("no cluster correction staged")
    for k in sorted(_path_kernels(pc)):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on this path")
    _check_native("unstructured", native_calls, UNSTRUCT_NATIVE_WRAPPERS)
    out["cluster_reference"] = _cluster_reference(pc)
    return p, pc, out


def _rel_err(y, want) -> float:
    return float((y - want).abs().max() / want.abs().max())


def _cluster_reference(pc) -> dict:
    """The staged cluster correction against its definition
    (``benchmark/reference/cluster_corr.py``) on the staged finest host
    matrix: the same clusters, as sets of rows, and ``cluster_apply``
    within ``TILE_ELL_F32_TOL`` of ``apply`` (float64 on the card)."""
    import torch

    from benchmark.reference import cluster_corr as ref
    from ngsamg_tpu_torch.smoothers.cluster_corr import cluster_apply

    t0 = time.perf_counter()
    cc = pc.op.cluster_corr
    A0 = pc.staged_host_matrices()[0]["A"]
    opts = pc.options.cluster_corr
    want = ref.detect(A0, opts.beta, opts.eig_ratio, opts.max_size)
    t1 = time.perf_counter()
    idx = cc.idx.cpu().numpy()
    real = np.diagonal(cc.inv.double().cpu().numpy(), axis1=1, axis2=2) != 0
    got = {frozenset(r[m].tolist()) for r, m in zip(idx, real)}
    same = got == {frozenset(c.tolist()) for c in want}
    apart = len(got ^ {frozenset(c.tolist()) for c in want})
    n = A0.shape[0]
    r = _rand_x(n, pc.A_dev.nrows_pad, torch.float32, 77)
    z = cluster_apply(cc, r)
    ref_z = ref.apply(want, A0, r[:n, 0].double())
    err = _rel_err(z[:n, 0].double(), ref_z)
    out = {"clusters": len(want), "width": max(len(c) for c in want),
           "same_sets": same, "apply_err": err, "detect_s": t1 - t0,
           "seconds": time.perf_counter() - t0}
    print("[unstructured] cluster reference " + json.dumps(out), flush=True)
    if not same:
        raise AssertionError(
            f"cluster sets differ: {len(got)} staged, {len(want)} by the "
            f"definition, {apart} in one of them only")
    if not err <= TILE_ELL_F32_TOL:
        raise AssertionError(f"cluster_apply off its definition by {err:.3e}")
    return out


# f32 tile-ELL products against the plain f64 product (one f32 rounding a
# partial sum of at most ~60 terms a row; TF32 or bf16 err by >= 5e-4),
# and the f64 twin
TILE_ELL_F32_TOL = 1e-5
TILE_ELL_F64_TOL = 1e-12


def phase_tile_ell(pc):
    """Plain torch tile-ELL matvec per tile-ELL level and transfer, timed
    and held to the plain f64 product of its staged host matrix
    (``benchmark/reference``), and the f64 twin of the finest level."""
    import torch

    from benchmark.reference import cluster_corr as ref
    from ngsamg_tpu_torch.sparse import formats
    from ngsamg_tpu_torch.utils.timing import event_ms

    t0 = time.perf_counter()
    host = pc.staged_host_matrices()
    check_s = time.perf_counter() - t0
    rows = []
    for lvl, lev in enumerate(pc.op.levels):
        for what, T in (("A", lev.A), ("P", lev.P), ("R", lev.R)):
            if not isinstance(T, (formats.TileELL, formats.TileELLStack)):
                continue
            blocks = T.blocks if isinstance(T, formats.TileELLStack) else (T,)
            slots = sum(int(b.cols.numel()) for b in blocks)
            nbytes = sum(b.data.numel() * b.data.element_size()
                         + b.cols.numel() * b.cols.element_size()
                         for b in blocks)
            x = _rand_x(T.ncols_pad, T.ncols_pad, torch.float32, 200 + lvl)
            ms = event_ms(lambda: formats.matvec(T, x))
            t1 = time.perf_counter()
            M = host[lvl][what]
            y = formats.matvec(T, x)
            err = _rel_err(y[: M.shape[0], 0].double(),
                           ref.operator(M, "cuda")(x[:, 0]))
            tail = float(y[M.shape[0]:].abs().max()) \
                if T.nrows_pad > M.shape[0] else 0.0
            check_s += time.perf_counter() - t1
            row = {"level": lvl, "op": what, "format": type(T).__name__,
                   "rows": T.nrows, "cols_pad": T.ncols_pad,
                   "buckets": len(blocks), "slots": slots,
                   "chunk": blocks[0].chunk_c, "bytes": nbytes, "ms": ms,
                   "ref_err": err}
            print("[tile_ell] " + json.dumps(row), flush=True)
            if not err <= TILE_ELL_F32_TOL or tail != 0.0:
                raise AssertionError(
                    f"tile-ELL {what}{lvl} off its host matrix by {err:.3e}"
                    f" (tol {TILE_ELL_F32_TOL:.0e}), pad tail max {tail}")
            rows.append(row)
    t1 = time.perf_counter()
    A64 = pc._ensure_A64_mixed()
    if not isinstance(A64, formats.TileELLStack):
        raise AssertionError(f"f64 twin: {type(A64).__name__}")
    x = _rand_x(A64.ncols_pad, A64.ncols_pad, torch.float64, 299)
    n = host[0]["A"].shape[0]
    err64 = _rel_err(formats.matvec(A64, x)[:n, 0],
                     ref.operator(host[0]["A"], "cuda")(x[:, 0]))
    check_s += time.perf_counter() - t1
    print("[tile_ell] " + json.dumps(
        {"level": 0, "op": "A64", "ref_err": err64,
         "reference_check_s": check_s}), flush=True)
    if not err64 <= TILE_ELL_F64_TOL:
        raise AssertionError(f"f64 twin off its host matrix by {err64:.3e}")
    return rows


def phase_tile_ell_kernel(pc, path):
    """The tile-ELL kernel on every tile-ELL level and transfer of ``pc``
    and on its f64 twin where that is tile-ELL: against the plain product
    on the card, two launches to the same bits, timed by CUDA-graph replay
    and after an L2 sweep beside the plain product and the bound by the
    problem's count."""
    import torch

    from ngsamg_tpu_torch.ops import tile_ell_cuda
    from ngsamg_tpu_torch.precond.amg import _full_f32
    from ngsamg_tpu_torch.sparse import formats
    from ngsamg_tpu_torch.utils.timing import cold_ms, graph_ms

    tile = (formats.TileELL, formats.TileELLStack)
    t0 = time.perf_counter()
    ops = [(f"{what}{lvl}", T) for lvl, lev in enumerate(pc.op.levels)
           for what, T in (("A", lev.A), ("P", lev.P), ("R", lev.R))
           if isinstance(T, tile)]
    A64 = pc._ensure_A64_mixed()
    if isinstance(A64, tile):
        ops.append(("A64", A64))
    if not ops:
        raise AssertionError(f"[tile-ell-kernel] {path}: no tile-ELL operator")
    rows = []
    for label, T in ops:
        L = T.launch
        dt = L.vals.dtype
        g = torch.Generator(device="cuda").manual_seed(500 + len(rows))
        x = torch.randn((T.ncols_pad, 1), generator=g, dtype=torch.float64,
                        device="cuda").to(dt)
        name = f"tile-ELL {path} {label} {dt}"
        key = _tile_ell_key(T)
        before = tile_ell_cuda.LAUNCHES[key]
        with _full_f32():
            _, rel = _check_kernel(T, x, formats.matvec,
                                   lambda A, v: A.product(v),
                                   TILE_ELL_KERNEL_TOL[str(dt)], name)
            _same_bits(formats.matvec, T, x, name)
            if tile_ell_cuda.LAUNCHES[key] != before + 3:
                raise AssertionError(f"{name}: {key} did not launch")
            us = 1e3 * graph_ms(lambda: formats.matvec(T, x))
            swept = 1e3 * cold_ms(lambda: formats.matvec(T, x))
            plain_us = 1e3 * graph_ms(lambda: T.product(x), n=10, reps=3)
            plain_swept = 1e3 * cold_ms(lambda: T.product(x), reps=5)
        item = x.element_size()
        nbytes = (L.nnz * (item + 4) + 4 * (T.nrows + 1)
                  + item * (T.ncols_pad + T.nrows))
        bound, by = _bound_ms(nbytes, 2 * L.nnz, dt)
        row = {"path": path, "op": label, "format": type(T).__name__,
               "dtype": str(dt).split(".")[-1], "rows": T.nrows,
               "cols_pad": T.ncols_pad, "nnz": L.nnz,
               "stored": L.vals.numel(), "mean": L.mean,
               "longest": L.longest, "plan": L.plan.variant,
               "rel_err": rel, "us": us, "swept_us": swept,
               "plain_us": plain_us, "plain_swept_us": plain_swept,
               "bytes": nbytes, "bound_us": bound * 1e3, "bound_by": by,
               "share_swept": bound * 1e3 / swept}
        print("[tile-ell-kernel] " + json.dumps(row), flush=True)
        rows.append(row)
    print(f"[tile-ell-kernel] {path}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def _traced_solve(pc, b):
    """``pc.solve(b, tol=1e-8)``, recording for each PCG pass its target
    and its own relative residual after every step (from the residual
    norm each step returns)."""
    from ngsamg_tpu_torch.solve import pcg as pcg_mod

    step = pcg_mod._pcg_step
    passes = []  # [the pass's tol_abs2 tensor, ||rhs||, relres per step]

    def traced(op, A, state, tol_abs2, **kw):
        if not passes or passes[-1][0] is not tol_abs2:
            passes.append([tol_abs2, float(state[4]) ** 0.5, []])
        state = step(op, A, state, tol_abs2, **kw)
        passes[-1][2].append(float(state[4]) ** 0.5 / passes[-1][1])
        return state

    pcg_mod._pcg_step = traced
    try:
        x, info = pc.solve(b, tol=1e-8)
    finally:
        pcg_mod._pcg_step = step
    return x, info, [{"target": float(t) ** 0.5 / b0, "relres": r}
                     for t, b0, r in passes]


def _k2_order_diagnostic(q, pc):
    """The card solve traced twice: as it runs, and with K2 swapped for its
    plain version (the plain summation order on the same card). Tells the
    kernel's summation order apart from the rest of the card's rounding;
    reports only."""
    from ngsamg_tpu_torch.ops import dia_cuda

    kernel = dia_cuda.dia_matvec

    def plain_k2(A, x):
        if A.sym_half:
            return kernel(A, x)
        return dia_cuda._dia_matvec_plain(A, x)

    out = {}
    for label in ("kernel", "plain"):
        dia_cuda.dia_matvec = kernel if label == "kernel" else plain_k2
        try:
            _x, info, passes = _traced_solve(pc, q.b)
        finally:
            dia_cuda.dia_matvec = kernel
        out[label] = {"iterations": int(info.iterations),
                      "outer_history": [float(h) for h in info.history],
                      "pcg_passes": passes}
    print("[unstructured-reference] K2 vs its plain version in the card "
          "solve: " + json.dumps(out), flush=True)
    return out


def phase_unstructured_reference():
    """unstructured_poisson(20, dim=3) on the card against the CPU, and
    each DIA level's kernel against its plain version at that shape.
    Returns the kernels' max|err| by name."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.ops import dia_cuda
    from ngsamg_tpu_torch.sparse import formats
    from ngsamg_tpu_torch.utils import fem

    q = fem.unstructured_poisson(20, dim=3)
    sols = {}
    for dev in ("cuda", "cpu"):
        _reset_counts()
        pcs = AMGPreconditioner(q.A, coords=q.coords, options=_cheb_opts(),
                                device=dev).setup()
        xs, inf = pcs.solve(q.b, tol=1e-8)
        sols[dev] = (pcs, xs, inf, _counts())
    (pg, xg, ig, lg), (_pcc, xc, ic, _lc) = sols["cuda"], sols["cpu"]
    diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
    relg = float(np.linalg.norm(q.b - q.A @ xg) / np.linalg.norm(q.b))
    fmts = [type(lev.A).__name__ for lev in pg.op.levels]
    print(f"[unstructured-reference] unstructured_poisson(20, 3): "
          f"{q.n} DoF, formats {fmts}, clusters "
          f"{None if pg.op.cluster_corr is None else list(pg.op.cluster_corr.idx.shape)}; "
          f"card {ig.iterations} it relres {relg:.3e}; cpu {ic.iterations} "
          f"it relres {ic.relres:.3e}; |x_card - x_cpu|/|x_cpu| {diff:.3e}; "
          f"card launches {lg}", flush=True)
    if not isinstance(pg.op.levels[0].A, formats.DiaMatrix):
        raise AssertionError(f"finest level {fmts[0]}, expected DiaMatrix")
    errs = {}
    for lvl, lev in enumerate(pg.op.levels):
        A = lev.A
        if not isinstance(A, formats.DiaMatrix):
            continue
        name = "dia_sym_matvec_f32" if A.sym_half else "dia_matvec_f32"
        x = _rand_x(A.nrows, A.nrows_pad, torch.float32, 300 + lvl)
        err, rel = _check_kernel(A, x, dia_cuda.dia_matvec,
                                 dia_cuda._dia_matvec_plain, F32_TOL,
                                 f"{name} unstructured level {lvl}")
        print(f"[unstructured-reference] {name} level {lvl}: rows {A.nrows} "
              f"diagonals {len(A.offsets)} max|err| {err:.3e} rel {rel:.3e}",
              flush=True)
        errs[name] = max(errs.get(name, 0.0), err)
    _k2_order_diagnostic(q, pg)
    if abs(ig.iterations - ic.iterations) > 1 or not ig.converged \
            or relg > 1e-8:
        raise AssertionError("unstructured solve on the card disagrees")
    if diff > 1e-6:
        raise AssertionError(f"unstructured solve differs from the CPU by {diff}")
    if lg["dia_matvec_f32"] <= 0:
        raise AssertionError("K2 never launched on the small unstructured solve")
    return errs


def phase_mis():
    """unstructured_poisson(20, dim=3) with MIS coarsening, card vs CPU."""
    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.config import CoarsenOptions, CoarsenType
    from ngsamg_tpu_torch.utils import fem

    q = fem.unstructured_poisson(20, dim=3)
    opts = _cheb_opts().replace(
        coarsen=CoarsenOptions(algo=CoarsenType.MIS))
    sols = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pcs = AMGPreconditioner(q.A, coords=q.coords, options=opts,
                                device=dev).setup()
        t1 = time.perf_counter()
        xs, inf = pcs.solve(q.b, tol=1e-8)
        sols[dev] = (pcs, np.asarray(xs), inf, t1 - t0,
                     time.perf_counter() - t1)
    (pg, xg, ig, _, _), (pcc, xc, ic, _, _) = sols["cuda"], sols["cpu"]
    relg = float(np.linalg.norm(q.b - q.A @ xg) / np.linalg.norm(q.b))
    diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
    out = {
        "dofs": int(q.n),
        "level_sizes": [int(v) for v in pg.log_.nvs],
        "operator_complexity": pg.operator_complexity,
        "card": {"iterations": int(ig.iterations), "relres_true": relg,
                 "setup_s": sols["cuda"][3], "solve_s": sols["cuda"][4]},
        "cpu": {"iterations": int(ic.iterations),
                "relres": float(ic.relres),
                "setup_s": sols["cpu"][3], "solve_s": sols["cpu"][4]},
        "x_diff": diff,
    }
    print("[mis] " + json.dumps(out), flush=True)
    if out["level_sizes"] != [int(v) for v in pcc.log_.nvs]:
        raise AssertionError("MIS hierarchy on the card differs from the CPU's")
    if pg.num_levels < 2:
        raise AssertionError("MIS coarsening built no coarse level")
    if abs(ig.iterations - ic.iterations) > 1 or not ig.converged \
            or relg > 1e-8:
        raise AssertionError("MIS solve on the card disagrees with the CPU")
    if diff > 1e-6:
        raise AssertionError(f"MIS solve differs from the CPU by {diff}")
    return out


ELAST_N = 36  # unstructured_elasticity(36, dim=3, refine=1)
ELAST_DOFS = 1250196
ELAST_MAX_IT = 40  # the reference's budget; the JAX package's record is 38
ELAST_JAX_NATIVE_IT = 38  # the JAX package's native run (PERF.md)
# this phase's host setup on the numpy branches (PERF.md section 5)
ELAST_NUMPY_SETUP_HOST_S = 183.6
# the native wrappers the JAX package's native run reaches on phase 9's
# path (tests/test_torch_native.py holds the port's calls to its calls);
# the other five block-setup wrappers are the branches behind the fused
# kernels, which phase 2a calls
ELAST_NATIVE_WRAPPERS = (
    "frob2_sym", "elast_ahat_bsr", "elast_rm_diag", "elast_soc_robust",
    "elast_map_edge_mats", "rho_power", "rap_bsr", "bsr_smooth_update",
    "truncate_prol_blocks", "bsr_sym_scale",
)
NATIVE_N = 12  # unstructured_elasticity(12, dim=3, refine=1): 48,660 DoF
# unstructured_poisson(16, dim=3, refine=1): 32,720 DoF
NATIVE_SCALAR_N = 16


def _operator_tensors(op):
    """Every tensor the staged operator holds, with a label."""
    import torch

    def walk(obj, label):
        if isinstance(obj, torch.Tensor):
            yield label, obj
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                yield from walk(getattr(obj, f.name), f"{label}.{f.name}")
        elif isinstance(obj, (tuple, list)):
            for i, v in enumerate(obj):
                yield from walk(v, f"{label}[{i}]")

    yield from walk(op, "op")


def phase_elasticity():
    """3D elasticity at 1,250,196 DoF on the card, mixed-precision PCG."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner, native
    from ngsamg_tpu_torch.sparse import bell
    from ngsamg_tpu_torch.utils import fem

    _reset_counts()
    native.reset_calls()
    t0 = time.perf_counter()
    p = fem.unstructured_elasticity(ELAST_N, dim=3, refine=1)
    t1 = time.perf_counter()
    pc = AMGPreconditioner(
        p.A, energy="elasticity", block_size=3, coords=p.coords,
        options=_cheb_opts(),
    ).setup()
    t2 = time.perf_counter()
    native_calls = _native_calls()
    pc.solve(p.b, maxiter=2, mixed=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    x, info = pc.solve(p.b, tol=1e-8, maxiter=120, mixed=True)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    before_warm = _counts()
    _x2, info2 = pc.solve(p.b, tol=1e-8, maxiter=120, mixed=True)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    launches = _counts()
    warm_bell = {k: launches[k] - before_warm[k]
                 for k in ("bell_matvec_f32", "bell_matvec_f64")}
    if x.shape != (p.n,) or not np.isfinite(x).all():
        raise AssertionError(f"solution: shape {x.shape}, not all finite")
    relres = float(np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b))
    # every level's kernel must launch (block-ELL: the f32 levels and the
    # f64 twin); dense levels run none
    for k in sorted(_path_kernels(pc)):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on this path")
    tensors = list(_operator_tensors(pc.op)) + list(
        _operator_tensors(pc._A64_mixed))
    off_card = [lab for lab, t in tensors if t.device.type != "cuda"]
    level_fmts = [type(lev.A).__name__ for lev in pc.op.levels]
    out = {
        "dofs": int(p.n),
        "device": str(pc.device),
        "assembly_s": t1 - t0,
        "setup_host_s": pc.setup_time_host,
        "setup_host_s_numpy_record": ELAST_NUMPY_SETUP_HOST_S,
        "card": _nvidia_smi(),
        "native_calls": native_calls,
        "setup_staging_s": pc.setup_time_device,
        "warmup_solve_s": t3 - t2,
        "solve_s": t4 - t3,
        "warm_solve_s": t5 - t4,
        "iterations": int(info.iterations),
        "restarts": int(info.outer_iterations) - 1,
        "warm_iterations": int(info2.iterations),
        "relres_true": relres,
        "relres_solver": float(info.relres),
        "num_levels": pc.num_levels,
        "operator_complexity": pc.operator_complexity,
        "level_sizes": [int(v) for v in pc.log_.nvs],
        "level_formats": level_fmts,
        "block_shapes": [
            [list(T.block_shape) if isinstance(T, bell.BlockELL) else None
             for T in (lev.A, lev.P, lev.R)] for lev in pc.op.levels],
        "twin": type(pc._A64_mixed).__name__,
        "tensors_on_card": len(tensors) - len(off_card),
        "device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_warm_solve": warm_bell,
    }
    print("[elasticity] " + json.dumps(out), flush=True)
    # the main path goes through the block-ELL kernel: a warm solve
    # launches it in f32 (the cycle) and in f64 (the twin)
    if min(warm_bell.values()) <= 0:
        raise AssertionError(f"a warm solve launched {warm_bell}")
    if pc.device.type != "cuda" or off_card:
        raise AssertionError(f"not on the card: {pc.device}, {off_card}")
    if int(p.n) != ELAST_DOFS:
        raise AssertionError(f"{p.n} DoF != {ELAST_DOFS}")
    if not isinstance(pc.A_dev, bell.BlockELL) or not isinstance(
            pc._A64_mixed, bell.BlockELL):
        raise AssertionError(f"finest level {level_fmts[0]}, twin "
                             f"{type(pc._A64_mixed).__name__}")
    if pc.op.coarse_inv.dtype != torch.float64:
        raise AssertionError("the coarse inverse is not f64")
    if not info.converged or relres > 1e-8:
        raise AssertionError(
            f"not converged: solver relres {info.relres}, true {relres}")
    if int(info.iterations) > ELAST_MAX_IT:
        raise AssertionError(f"{info.iterations} iterations > {ELAST_MAX_IT}")
    if abs(int(info.iterations) - ELAST_JAX_NATIVE_IT) > 1:
        raise AssertionError(f"{info.iterations} iterations, the JAX "
                             f"package's native run {ELAST_JAX_NATIVE_IT}")
    _check_native("elasticity", native_calls, ELAST_NATIVE_WRAPPERS)
    return p, pc, out


def _bell_work(T) -> tuple:
    """(operations, bytes) of one matvec by the problem's count, as
    benchmark/roofline.py counts the finest level: each stored block once
    (its values and a 4-byte column index), a 4-byte row pointer a row
    and one more, x read once and y written once, in the operator's
    precision. The padding of the ELL storage is no part of it."""
    br, cbc = T.block_shape
    bc = cbc // T.col_chunk
    item = T.data.element_size()
    blocks = (int(T.nslots.sum()) if T.nslots is not None
              else T.nrows_pad * T.ell_width)
    nbytes = (blocks * (br * bc * item + 4) + 4 * (T.nrows + 1)
              + (T.ncols * bc + T.nrows * br) * item)
    return 2 * br * bc * blocks, nbytes


def _bell_plans(T):
    """Every plan the kernel takes for T's shape (the sweep)."""
    from ngsamg_tpu_torch.ops import bell_cuda

    n, K, br, bcw = T.data.shape
    plans = [bell_cuda.bell_plan(K, br, bcw, n, lanes=l, warps=1)
             for l in (1, 2, 4, 8, 16, 32)]
    if T.launch.staged:
        plans += [bell_cuda.bell_plan(K, br, bcw, n, lanes=32, warps=w)
                  for w in (2, 4, 8)]
    return plans


def phase_block_ell(pc):
    """The block-ELL kernel on every block-ELL level and transfer (f32)
    and on the finest level's f64 twin: checked against the plain version
    on the card, two launches to the same bits, timed by CUDA-graph replay
    and after an L2 sweep, beside the plain version, every other plan and
    the bound by the problem's count (and by the padded storage)."""
    import torch

    from ngsamg_tpu_torch.ops import bell_cuda
    from ngsamg_tpu_torch.precond.amg import _full_f32
    from ngsamg_tpu_torch.sparse import bell
    from ngsamg_tpu_torch.utils.timing import cold_ms, graph_ms

    ops = [("A64", 0, pc._A64_mixed)]
    for lvl, lev in enumerate(pc.op.levels):
        ops += [(what, lvl, T) for what, T in
                (("A", lev.A), ("P", lev.P), ("R", lev.R))]
    rows = []
    for what, lvl, T in ops:
        if not isinstance(T, bell.BlockELL):
            continue
        dt = T.data.dtype
        br, cbc = T.block_shape
        bc = cbc // T.col_chunk
        nx = -(-T.ncols // 8) * 8
        g = torch.Generator(device="cuda")
        g.manual_seed(400 + lvl)
        x = torch.randn((nx, bc), dtype=dt, device="cuda", generator=g)
        label = f"block-ELL {what}{lvl} {dt}"
        key = "bell_matvec_" + ("f64" if dt == torch.float64 else "f32")
        before = bell_cuda.LAUNCHES[key]
        _, rel = _check_kernel(T, x, bell.spmv, bell._spmv_plain,
                               BELL_TOL[str(dt)], label)
        _same_bits(bell.spmv, T, x, label)
        if bell_cuda.LAUNCHES[key] != before + 3:
            raise AssertionError(f"{label}: {key} did not launch")
        with _full_f32():
            ms = graph_ms(lambda: bell.spmv(T, x), n=10)
            swept = cold_ms(lambda: bell.spmv(T, x))
            plain_ms = graph_ms(lambda: bell._spmv_plain(T, x), n=10)
            sweep = {
                p.variant: graph_ms(
                    lambda p=p: bell_cuda.bell_matvec(T, x, plan=p), n=10)
                for p in _bell_plans(T)
            }
        flops, nbytes = _bell_work(T)
        stored = (T.data.numel() * T.data.element_size()
                  + T.cols.numel() * T.cols.element_size())
        bound, by = _bound_ms(nbytes, flops, dt)
        stored_bound, _ = _bound_ms(
            stored + (x.numel() + T.nrows_pad * br) * x.element_size(),
            2 * T.data.numel(), dt)
        best = min(sweep, key=sweep.get)
        row = {"level": lvl, "op": what, "dtype": str(dt).split(".")[-1],
               "rows": T.nrows, "cols": T.ncols, "slots": T.ell_width,
               "real_slots_mean": flops / (2 * br * bc) / max(T.nrows, 1),
               "block": [br, bc], "plan": T.launch.variant,
               "us": ms * 1e3, "swept_us": swept * 1e3,
               "plain_us": plain_ms * 1e3,
               "best_plan": best, "best_us": sweep[best] * 1e3,
               "sweep_us": {k: v * 1e3 for k, v in sweep.items()},
               "bytes": nbytes, "bound_us": bound * 1e3, "bound_by": by,
               "share_of_bound": bound / ms,
               "swept_share_of_bound": bound / swept,
               "stored_bytes": stored, "stored_bound_us": stored_bound * 1e3,
               "rel_err": rel}
        print("[block_ell] " + json.dumps(row), flush=True)
        rows.append(row)
    if not rows:
        raise AssertionError("no block-ELL operator in the hierarchy")
    return rows


def phase_elasticity_reference():
    """elasticity_3d(8) on the card against the CPU, mixed and plain; and
    bell.spmv on the card against the CPU at the four block shapes."""
    import scipy.sparse as sp
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.precond.amg import _full_f32
    from ngsamg_tpu_torch.sparse import bell
    from ngsamg_tpu_torch.utils import fem

    q = fem.elasticity_3d(8)
    pcs = {
        dev: AMGPreconditioner(
            q.A, energy="elasticity", block_size=3, coords=q.coords,
            options=_cheb_opts(), device=dev,
        ).setup()
        for dev in ("cuda", "cpu")
    }
    out = {"dofs": int(q.n),
           "level_sizes": [int(v) for v in pcs["cuda"].log_.nvs],
           "level_formats": [type(lev.A).__name__
                             for lev in pcs["cuda"].op.levels]}
    for mixed in (True, None):
        (xg, ig), (xc, ic) = (
            pcs[dev].solve(q.b, tol=1e-8, mixed=mixed)
            for dev in ("cuda", "cpu"))
        relg = float(np.linalg.norm(q.b - q.A @ xg) / np.linalg.norm(q.b))
        diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
        key = "mixed" if mixed else "plain"
        out[key] = {"card_iterations": int(ig.iterations),
                    "cpu_iterations": int(ic.iterations),
                    "card_relres_true": relg, "x_diff": diff}
        # the plain solve's f32 passes each end where the f32 recursive
        # residual drifts under 2e-6 while the true one is 1e2-1e5 above
        # it, so its count follows the rounding (the same count under
        # b (1 + k 1e-3), printed): its cycle is held to the CPU's in f64
        # below, its result here
        if (mixed and abs(ig.iterations - ic.iterations) > 1) \
                or not ig.converged or relg > 1e-8:
            raise AssertionError(f"elasticity_3d(8) {key} on the card "
                                 f"disagrees with the CPU: {out[key]}")
        if diff > 1e-6:
            raise AssertionError(f"elasticity_3d(8) {key} differs from the "
                                 f"CPU by {diff}")
    out["plain"]["iterations_scaled_b"] = {
        dev: [int(pcs[dev].solve(q.b * (1 + k * 1e-3), tol=1e-8)[1]
                  .iterations) for k in range(6)]
        for dev in ("cuda", "cpu")}
    # the plain path with an f64 cycle: exact defect correction, whose
    # count the rounding does not move
    runs64 = {}
    for dev in ("cuda", "cpu"):
        opts64 = _cheb_opts()
        opts64.dtype = "float64"
        pc64 = AMGPreconditioner(
            q.A, energy="elasticity", block_size=3, coords=q.coords,
            options=opts64, device=dev,
        ).setup()
        x64, i64 = pc64.solve(q.b, tol=1e-8)
        runs64[dev] = (x64, i64)
    (xg, ig), (xc, ic) = runs64["cuda"], runs64["cpu"]
    out["plain_f64"] = {
        "card_iterations": int(ig.iterations),
        "cpu_iterations": int(ic.iterations),
        "card_relres_true": float(np.linalg.norm(q.b - q.A @ xg)
                                  / np.linalg.norm(q.b)),
        "x_diff": float(np.linalg.norm(xg - xc) / np.linalg.norm(xc)),
    }
    if abs(ig.iterations - ic.iterations) > 1 or not ig.converged \
            or out["plain_f64"]["card_relres_true"] > 1e-8 \
            or out["plain_f64"]["x_diff"] > 1e-6:
        raise AssertionError(f"elasticity_3d(8) plain f64 on the card "
                             f"disagrees with the CPU: {out['plain_f64']}")
    if not isinstance(pcs["cuda"].A_dev, bell.BlockELL):
        raise AssertionError("elasticity_3d(8): finest level not block-ELL")
    rng = np.random.default_rng(11)
    errs = {}
    for br, bc in ((3, 3), (6, 6), (3, 6), (6, 3)):
        nbr, nbc = 4001, (4001 if br == bc else 1733)
        S = sp.random(nbr, nbc, density=12.0 / nbc, random_state=5,
                      format="csr")
        B = sp.bsr_matrix(
            (rng.standard_normal((S.nnz, br, bc)), S.indices, S.indptr),
            shape=(nbr * br, nbc * bc))
        x = rng.standard_normal((-(-nbc // 8) * 8, bc)).astype(np.float32)
        ys = {}
        for dev in ("cuda", "cpu"):
            T = bell.from_scipy(B, br, bc, dtype=np.float32, device=dev)
            with _full_f32():
                ys[dev] = bell.spmv(T, torch.from_numpy(x).to(dev)).cpu()
        err = float((ys["cuda"] - ys["cpu"]).abs().max()
                    / ys["cpu"].abs().max())
        errs[f"{br}x{bc}"] = err
        if err > 1e-5:
            raise AssertionError(f"bell.spmv {br}x{bc}: card vs CPU {err}")
    out["spmv_card_vs_cpu"] = errs
    print("[elasticity-reference] " + json.dumps(out), flush=True)
    out["device_pencils"] = phase_device_pencils()
    return out


GS_N = 101  # fem.poisson_3d(101): the GS leg of bench.py, 1,000,000 DoF
GS_DOFS = 1000000
# the JAX package's native run of this problem (CPU): levels, operator
# complexity, colors per GS level
GS_LEVELS = 5
GS_OC = 2.076
GS_COLORS = [2, 16, 56, 199]
GS_MAX_IT = 16  # the JAX package takes 15
# the native wrappers the JAX package's native run reaches with the default
# options (GS) and with Chebyshev on the lattice path (the CPU test's
# h1_gs and h1_lattice problems)
GS_NATIVE_WRAPPERS = (
    "greedy_color", "finest_mesh_scal", "map_edges_agg", "rap_csr",
    "csr_permute", "tile_ell_pack",
)
CHEB_NATIVE_WRAPPERS = ("rap_csr", "rho_power")
# the GS run's host setup and staging on the numpy branches, seconds
# (PERF.md section 5)
GS_NUMPY_RECORD = {"setup_host_s": [3.438, 4.303],
                   "setup_staging_s": [6.127, 7.502]}
# the JAX package's iterations on the lattice path of poisson_3d(101)
CYCLE_RUNS = {  # label: (smoother, cycle, iterations)
    "W": ("chebyshev", "W", 9),
    "BS": ("chebyshev", "BS", 6),
    "jacobi": ("jacobi", "V", 23),
    "l1_jacobi": ("l1_jacobi", "V", 23),
}


def _options(smoother=None, cycle="V", **kw):
    """AMGOptions(), with the smoother and cycle replaced where given."""
    from ngsamg_tpu_torch import AMGOptions, CycleType
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType

    opts = AMGOptions(cycle=CycleType(cycle), **kw)
    if smoother is not None:
        opts.smoother = SmootherOptions(type=SmootherType(smoother))
    return opts


def _profiled_launches(fn) -> int:
    """Device kernels one call of ``fn`` launches (copies and memsets
    apart), counted by ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    return sum(
        1 for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not e.name.lower().startswith(("memcpy", "memset"))
    )


def _colors(pc) -> list:
    """Colors per level of the (block) GS smoothers."""
    return [len(lev.smoother.color_bounds) - 1 for lev in pc.op.levels
            if hasattr(lev.smoother, "color_bounds")]


def _solve_run(p, opts, label, warm=3, profile=True):
    """Set ``p`` up on the card with ``opts`` and solve it: first solve,
    ``warm`` warm solves (the median; the launch counters read over the
    first of them) and, with ``profile``, the kernels of one more warm
    solve counted by the profiler. Returns (pc, out)."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner, native

    _reset_counts()
    native.reset_calls()
    t0 = time.perf_counter()
    pc = AMGPreconditioner(p.A, coords=p.coords, options=opts,
                           device="cuda").setup()
    t1 = time.perf_counter()
    native_calls = _native_calls()

    def solve():
        return pc.solve(p.b, tol=1e-8, return_device=True)

    x, info = solve()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walls = []
    for k in range(warm):
        if k == 0:
            _reset_counts()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t3)
        if k == 0:
            warm_launches = _counts()
    xh = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if xh.shape != (p.n,) or not np.isfinite(xh).all():
        raise AssertionError(f"{label}: solution shape {xh.shape} or not finite")
    relres = float(np.linalg.norm(p.b - p.A @ xh) / np.linalg.norm(p.b))
    off_card = [lab for lab, t in _operator_tensors(pc.op)
                if t.device.type != "cuda"]
    out = {
        "dofs": int(p.n),
        "num_levels": pc.num_levels,
        "operator_complexity": pc.operator_complexity,
        "level_sizes": [int(v) for v in pc.log_.nvs],
        "level_formats": [type(lev.A).__name__ for lev in pc.op.levels],
        "colors": _colors(pc),
        "iterations": int(info.iterations),
        "outer_iterations": int(info.outer_iterations),
        "relres_true": relres,
        "setup_host_s": pc.setup_time_host,
        "setup_staging_s": pc.setup_time_device,
        "staging_stages_s": pc._device_stage_times,
        "native_calls": native_calls,
        "first_solve_s": t2 - t1,
        "warm_solves_s": walls,
        "warm_solve_s": float(np.median(walls)),
        "kernel_launches_warm": warm_launches,
    }
    if profile:
        out["profiled_launches_warm"] = _profiled_launches(solve)
    if off_card:
        raise AssertionError(f"{label}: not on the card: {off_card[:5]}")
    if not info.converged or relres > 1e-8:
        raise AssertionError(
            f"{label}: not converged: solver relres {info.relres}, true "
            f"{relres}")
    return pc, out


def phase_gs(p):
    """poisson_3d(101) with the JAX package's default options (multicolor
    GS, V-cycle), then with Chebyshev, on the card."""
    _pc, gs = _solve_run(p, _options(), "gs")
    phase_gs_kernel(_pc, p)
    phase_tile_ell_kernel(_pc, "gs")
    del _pc
    _pc, cheb = _solve_run(p, _options("chebyshev"), "chebyshev")
    on_path = sorted(_path_kernels(_pc))
    del _pc
    out = {"gs": gs, "chebyshev": cheb,
           "solve_ratio_gs_over_cheb": gs["warm_solve_s"] / cheb["warm_solve_s"],
           "gs_setup_numpy_record": GS_NUMPY_RECORD, "card": _nvidia_smi()}
    print("[gs] " + json.dumps(out), flush=True)
    _check_native("gs", gs["native_calls"], GS_NATIVE_WRAPPERS)
    _check_native("gs (Chebyshev)", cheb["native_calls"],
                  CHEB_NATIVE_WRAPPERS)
    for k in on_path:
        if cheb["kernel_launches_warm"][k] <= 0:
            raise AssertionError(f"kernel {k} never launched (Chebyshev)")
    if int(p.n) != GS_DOFS:
        raise AssertionError(f"{p.n} DoF != {GS_DOFS}")
    if gs["num_levels"] != GS_LEVELS:
        raise AssertionError(f"GS: {gs['num_levels']} levels != {GS_LEVELS}")
    if abs(gs["operator_complexity"] / GS_OC - 1) > 0.005:
        raise AssertionError(f"GS: operator complexity "
                             f"{gs['operator_complexity']} != {GS_OC}")
    if gs["colors"] != GS_COLORS:
        raise AssertionError(f"GS: colors {gs['colors']} != {GS_COLORS}")
    if gs["iterations"] > GS_MAX_IT:
        raise AssertionError(f"GS: {gs['iterations']} iterations > {GS_MAX_IT}")
    for k in ("gs_colour_f32", "gs_sweep_f32"):
        if gs["kernel_launches_warm"][k] <= 0:
            raise AssertionError(f"GS: kernel {k} never launched")
    return out


# [gs-kernel]: the launch shape each level of the GS hierarchy takes, and
# the limit of the sweep against its float64 definition (PERF.md section 2)
GS_ROUTES = ["colour", "colour", "sweep", "sweep"]
GS_SWEEP_TOL = 2e-5


def phase_gs_kernel(pc, p):
    """Levels 0-3 of the GS hierarchy: a forward and a backward sweep from
    a nonzero x by the kernel against ``blocked_sweep`` in float64 on the
    level's own (permuted, scaled) matrix, on the launch shape GS_ROUTES
    names; the device time a sweep (CUDA-graph replay) of the kernel and of
    the plain version, the kernel after an L2 sweep, one call of each, and
    the bound by ``benchmark/gs_work.py``'s count, as ``gs_sweep_roofline``
    counts it: level 0 from the problem's stencil (``p.A`` as a DIA
    matrix), the coarser levels from their matrices."""
    import scipy.sparse as sp
    import torch

    from benchmark import gs_work, roofline
    from benchmark.reference import gs_sweep
    from ngsamg_tpu_torch.ops import gs_cuda
    from ngsamg_tpu_torch.smoothers import core
    from ngsamg_tpu_torch.sparse import bell
    from ngsamg_tpu_torch.utils import timing

    t0 = time.perf_counter()
    rows = []
    for i, lev in enumerate(pc.op.levels[:-1]):
        sm, A = lev.smoother, lev.A
        n = A.nrows
        M = bell.to_scipy(A)
        csr = gs_sweep.Csr(M, "cuda")
        work = gs_work.sweep_work(sp.dia_matrix(p.A) if i == 0 else M)
        t_bound, _by = roofline.bound_s(*work)
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.zeros((A.nrows_pad, 1), device="cuda")
        b = torch.zeros_like(x)
        x[:n, 0] = torch.randn(n, generator=g, device="cuda")
        b[:n, 0] = torch.randn(n, generator=g, device="cuda")
        row = {"level": i, "rows": n, "colours": len(sm.color_bounds) - 1,
               "K": A.ell_width, "plan": sm.launch.variant,
               "bytes": work[1], "bound_us": t_bound * 1e6}
        for way, fn, reverse in (("forward", core.smooth, False),
                                 ("backward", core.smooth_back, True)):
            key = f"gs_{sm.launch.route}_f32"
            before = gs_cuda.LAUNCHES[key]
            y = fn(sm, A, x, b)
            launched = gs_cuda.LAUNCHES[key] - before
            ref = gs_sweep.blocked_sweep(csr, sm.color_bounds,
                                         x[:n, 0].double(), b[:n, 0].double(),
                                         reverse)
            err = float((y[:n, 0].double() - ref).abs().max()
                        / ref.abs().max())

            def kernel(fn=fn):
                return fn(sm, A, x, b)

            def plain_run(reverse=reverse):
                return core.gs_plain(sm, A, x, b, reverse=reverse)

            row[way] = {
                "err": err, "launches": launched,
                "device_us": 1e3 * timing.graph_ms(kernel, n=20),
                "cold_us": 1e3 * timing.cold_ms(kernel),
                "call_us": 1e3 * timing.event_ms(kernel),
                "plain_device_us": 1e3 * timing.graph_ms(plain_run, n=3,
                                                         reps=3),
                "plain_call_us": 1e3 * timing.event_ms(plain_run, reps=5),
            }
            if not err <= GS_SWEEP_TOL:
                raise AssertionError(f"gs-kernel level {i} {way}: {err:.3e}")
            if sm.launch.route != GS_ROUTES[i] or not launched:
                raise AssertionError(f"gs-kernel level {i}: "
                                     f"{sm.launch.variant}, {launched} "
                                     "launches")
        row["share_pct"] = 100 * 2 * row["bound_us"] / (
            row["forward"]["cold_us"] + row["backward"]["cold_us"])
        rows.append(row)
        print("[gs-kernel] " + json.dumps(row), flush=True)
    print(f"[gs-kernel] {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def phase_cycles(p):
    """W and BS cycles (Chebyshev) and Jacobi / l1-Jacobi V-cycles on the
    lattice path of ``p``: each launches K1, K2 and K3."""
    out = {}
    for label, (smoother, cycle, jax_it) in CYCLE_RUNS.items():
        pc, run = _solve_run(p, _options(smoother, cycle), label, warm=1,
                             profile=False)
        run["jax_iterations"] = jax_it
        out[label] = run
        print(f"[cycles] {label} " + json.dumps(run), flush=True)
        if abs(run["iterations"] - jax_it) > 1:
            raise AssertionError(f"{label}: {run['iterations']} iterations, "
                                 f"the JAX package's {jax_it}")
        launches = run["kernel_launches_warm"]
        k1 = [k for k in launches if k.startswith("stencil") and
              k.endswith("f32") and launches[k] > 0]
        for k, name in ((k1, "K1"), (launches["dia_matvec_f32"], "K2"),
                        (launches["dia_sym_matvec_f32"], "K3")):
            if not k:
                raise AssertionError(f"{label}: {name} never launched")
        del pc
    return out


def _random_spd_bsr(nb, bs, seed):
    """A symmetric, block-diagonally dominant random BSR matrix."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    S = sp.random(nb, nb, density=8.0 / nb, random_state=seed, format="csr")
    S = ((S + S.T) != 0).astype(float).tocsr()
    S.setdiag(0)
    S.eliminate_zeros()
    S = (S + sp.eye(nb)).tocsr()
    blocks = rng.standard_normal((S.nnz, bs, bs)) * 0.1
    B = sp.bsr_matrix((blocks, S.indices, S.indptr), shape=(nb * bs, nb * bs))
    return (B + B.T + 4.0 * bs * sp.eye(nb * bs)).tocsr()


def phase_gs_reference():
    """Card against CPU: default-option solves, dyn-block GS, the
    stationary iteration; spmv_rows and one GS sweep at three block
    sizes."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.smoothers import build, core
    from ngsamg_tpu_torch.solve.pcg import amg_iteration
    from ngsamg_tpu_torch.sparse import bell
    from ngsamg_tpu_torch.utils import fem

    out = {}

    def card_vs_cpu(label, q, pcs, it_band=1, **solve_kw):
        (xg, ig), (xc, ic) = (pcs[dev].solve(q.b, tol=1e-8, **solve_kw)
                              for dev in ("cuda", "cpu"))
        relg = float(np.linalg.norm(q.b - q.A @ xg) / np.linalg.norm(q.b))
        diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
        out[label] = {"dofs": int(q.n), "colors": _colors(pcs["cuda"]),
                      "card_iterations": int(ig.iterations),
                      "cpu_iterations": int(ic.iterations),
                      "card_relres_true": relg, "x_diff": diff}
        if abs(ig.iterations - ic.iterations) > it_band or not ig.converged \
                or relg > 1e-8 or diff > 1e-6:
            raise AssertionError(f"{label}: card against CPU {out[label]}")

    def both(q, opts, **kw):
        return {dev: AMGPreconditioner(q.A, coords=q.coords, options=opts,
                                       device=dev, **kw).setup()
                for dev in ("cuda", "cpu")}

    q = fem.poisson_3d(24)
    card_vs_cpu("poisson_3d(24)", q, both(q, _options()))
    q = fem.elasticity_3d(8)
    pcs = both(q, _options(), energy="elasticity", block_size=3)
    card_vs_cpu("elasticity_3d(8) mixed", q, pcs, mixed=True)
    # plain f32 defect correction: each of its five passes stalls at the
    # f32 floor, and where it stops follows the rounding (the JAX package
    # itself takes 53 iterations native and 50 on its numpy branches on one
    # CPU; an H100 56 against 54 on its host's CPU, the solutions within
    # 1e-11 of each other): a 10% band
    card_vs_cpu("elasticity_3d(8) plain", q, pcs, it_band=6)
    q = fem.poisson_2d(32)
    card_vs_cpu("dyn_bgs f64 poisson_2d(32)", q,
                both(q, _options("dyn_bgs", dtype="float64")))
    # the stationary AMG iteration, f64 hierarchy
    q = fem.poisson_3d(24)
    its = {}
    for dev in ("cuda", "cpu"):
        pc = AMGPreconditioner(q.A, coords=q.coords, device=dev,
                               options=_options(dtype="float64")).setup()
        res = amg_iteration(pc.op, pc.A_dev, pc._to_dev(q.b), tol=1e-8,
                            maxiter=100)
        its[dev] = (int(res.iterations), pc._from_dev(res.x))
    diff = float(np.linalg.norm(its["cuda"][1] - its["cpu"][1])
                 / np.linalg.norm(its["cpu"][1]))
    out["amg_iteration f64 poisson_3d(24)"] = {
        "card_iterations": its["cuda"][0], "cpu_iterations": its["cpu"][0],
        "x_diff": diff}
    if abs(its["cuda"][0] - its["cpu"][0]) > 1 or its["cuda"][0] >= 100 \
            or diff > 1e-6:
        raise AssertionError(f"amg_iteration: card against CPU "
                             f"{out['amg_iteration f64 poisson_3d(24)']}")
    # spmv_rows and one GS sweep (split storage, two steps) at bs 1, 3, 6
    errs = {}
    opts = _options().smoother
    for bs in (1, 3, 6):
        A = _random_spd_bsr(3001, bs, 20 + bs)
        perm, cb = build.plan_row_order(A, bs, opts, 0)
        sperm = (perm[:, None] * bs + np.arange(bs)).ravel()
        A = A[sperm][:, sperm].tocsr()
        data, cols, nb, nslots = bell.pack(A, bs, bs, np.float32, 8)
        sm = build.build_smoother(A, bs, opts, 0, data.shape[0], np.float32,
                                  color_bounds=cb, ell=(data, cols))
        rng = np.random.default_rng(30 + bs)
        b = np.zeros((data.shape[0], bs), np.float32)
        b[:nb] = rng.standard_normal((nb, bs))
        x0 = np.zeros_like(b)
        x0[:nb] = rng.standard_normal((nb, bs))
        rows = rng.integers(0, nb, 777)
        ys = {}
        for dev in ("cuda", "cpu"):
            T = bell.from_packed(data, cols, nb, nb, device=dev,
                                 nslots=nslots)
            smd = build.stage_smoother(sm, dev, A=T)
            bt, xt = (torch.from_numpy(v).to(dev) for v in (b, x0))
            ys[dev] = (
                bell.spmv_rows(T, xt, torch.from_numpy(rows).to(dev)).cpu(),
                core.smooth_back(smd, T, core.smooth(smd, T, xt, bt),
                                 bt).cpu(),
            )
        for k, what in enumerate(("spmv_rows", "gs_sweep")):
            a, c = ys["cuda"][k], ys["cpu"][k]
            err = float((a - c).abs().max() / c.abs().max())
            errs[f"{what} bs {bs}"] = err
            if not np.isfinite(err) or err > 1e-5:
                raise AssertionError(f"{what} bs {bs}: card against CPU {err}")
    out["card_vs_cpu"] = errs
    print("[gs-reference] " + json.dumps(out), flush=True)
    return out


def phase_selftest(pc):
    """The JAX package's self-tests on the headline preconditioner: the
    bounds of M^-1 A, of every tail hierarchy and the smoother rates, with
    the seconds and the kernel launches of each."""
    import torch

    out = {}
    for name, run in (("test", lambda: pc.test(60)),
                      ("test_levels", lambda: pc.test_levels(30)),
                      ("test_smoothers", lambda: pc.test_smoothers(4))):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0, "result": res,
                     "launches": {k: v for k, v in _counts().items() if v}}
    print("[selftest] " + json.dumps(out), flush=True)
    print(f"[selftest] {sum(v['s'] for v in out.values()):.1f} s",
          flush=True)
    lmin, lmax = out["test"]["result"]
    if not 0.05 < lmin <= lmax < 1.05:
        raise AssertionError(f"selftest: bounds [{lmin}, {lmax}]")
    for lvl, (lo, hi) in enumerate(out["test_levels"]["result"]):
        if not 0.15 < lo <= hi < 1.3:
            raise AssertionError(f"selftest: level {lvl} bounds [{lo}, {hi}]")
    if not all(0 <= r < 1 for r in out["test_smoothers"]["result"]):
        raise AssertionError(f"selftest: smoother rates "
                             f"{out['test_smoothers']['result']}")
    for name in ("test_levels", "test_smoothers"):
        for k in KERNELS:
            if k.endswith("_f32") and not out[name]["launches"].get(k):
                raise AssertionError(f"selftest: {name} never launched {k}")
    return out


def _bf16_kernel_rows(pcb, f32_rows):
    """K1 (tiled and general), K3 and K2 in bf16 at the headline's level
    shapes: against their plain bf16 versions, two launches to the same
    bits, device times beside the f32 level's, bounds at 2 bytes a value."""
    import torch

    from ngsamg_tpu_torch.ops import dia_cuda, stencil_cuda
    from ngsamg_tpu_torch.sparse import formats
    from ngsamg_tpu_torch.utils.timing import cold_ms, graph_ms

    f32_ms = {(row["name"], e["level"]): e["device_ms"]
              for row in f32_rows for e in row["levels"]}
    bf = torch.bfloat16
    per_kernel = {}
    for lvl, lev in enumerate(pcb.op.levels):
        A = lev.A
        if isinstance(A, formats.StencilDia):
            name = _stencil_key(A, bf)
            kern, plain = stencil_cuda.stencil_matvec, \
                stencil_cuda._stencil_matvec_plain
            library = _conv3d_call
        elif isinstance(A, formats.DiaMatrix):
            name = "dia_sym_matvec_bf16" if A.sym_half else "dia_matvec_bf16"
            kern, plain = dia_cuda.dia_matvec, dia_cuda._dia_matvec_plain
            library = _csr_call
        else:
            continue
        x = _rand_x(A.nrows, A.nrows_pad, bf, 200 + lvl)
        err, rel = _check_kernel(A, x, kern, plain, BF16_TOL,
                                 f"{name} level {lvl}")
        _same_bits(kern, A, x, f"{name} level {lvl}")
        nbytes, flops = _level_cost(A, bf)
        bound_ms, bound_by = _bound_ms(nbytes, flops, bf)
        lib = library(A, x)  # conv3d and cuSPARSE both take bf16
        entry = {
            "level": lvl, "rows": A.nrows, "variant": _variant(A),
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "rel_err": rel,
            "device_ms": graph_ms(lambda: kern(A, x)),
            "cold_ms": cold_ms(lambda: kern(A, x)),
            "plain_ms": graph_ms(lambda: plain(A, x), n=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if lib is None else graph_ms(lib),
            "f32_device_ms": f32_ms.get((name.replace("_bf16", "_f32"), lvl)),
        }
        entry["share_of_bound"] = bound_ms / entry["device_ms"]
        if entry["variant"] == "tiled3d":
            # the general K1 in bf16 on the same level
            meta = stencil_cuda._device_meta(A.offs, A.dims, x.device)

            def general():
                return stencil_cuda._launch_general(A, x, meta)

            entry["general_max_abs_err"], _ = _check_kernel(
                A, x, lambda A_, x_: general(), plain, BF16_TOL,
                f"{name} general kernel, level {lvl}")
            y1, y2 = general(), general()
            torch.cuda.synchronize()
            if not torch.equal(y1, y2):
                raise AssertionError("stencil_matvec_bf16: launches differ")
            entry["general_ms"] = graph_ms(general)
        print(f"[bf16] {name} " + json.dumps(entry), flush=True)
        per_kernel.setdefault(name, []).append(entry)
    if set(per_kernel) != set(BF16_KERNELS):
        raise AssertionError(f"bf16 headline levels run {sorted(per_kernel)}")
    return per_kernel


def phase_bf16(p, f32_rows):
    """The bf16 device dtype: kernels at the headline's shapes, the bf16
    path's launches, and three solves on the card against the CPU."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.utils import fem

    t0 = time.perf_counter()
    bf_opts = _cheb_opts().replace(dtype="bfloat16")
    pcb = AMGPreconditioner(p.A, coords=p.coords, options=bf_opts,
                            device="cuda").setup()
    per_kernel = _bf16_kernel_rows(pcb, f32_rows)
    # the bf16 path: the headline solved in bf16 from counters at 0
    _reset_counts()
    _x, info = pcb.solve(p.b, tol=1e-8, return_device=True)
    torch.cuda.synchronize()
    launches = _counts()
    path = {"iterations": int(info.iterations),
            "outer_iterations": int(info.outer_iterations),
            "converged": bool(info.converged), "history": info.history,
            "launches": {k: v for k, v in launches.items() if v}}
    print("[bf16] headline solve " + json.dumps(path), flush=True)
    for k in BF16_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"bf16 path: {k} never launched")
    del pcb
    solves = {}
    for label, n, cheb in (("poisson_3d(12) default", 12, False),
                           ("poisson_3d(24) chebyshev", 24, True),
                           ("poisson_3d(40) chebyshev", 40, True)):
        q = fem.poisson_3d(n)
        opts = (_cheb_opts() if cheb else _options()).replace(
            dtype="bfloat16")
        res = {}
        for dev in ("cuda", "cpu"):
            _reset_counts()
            pcs = AMGPreconditioner(q.A, coords=q.coords, options=opts,
                                    device=dev).setup()
            xs, inf = pcs.solve(q.b, tol=1e-8)
            res[dev] = {
                "iterations": int(inf.iterations),
                "outer_iterations": int(inf.outer_iterations),
                "converged": bool(inf.converged),
                "relres_true": float(np.linalg.norm(q.b - q.A @ xs)
                                     / np.linalg.norm(q.b)),
                "history": inf.history,
                "finest": type(pcs.op.levels[0].A).__name__,
            }
            if dev == "cuda":
                res[dev]["launches"] = {k: v for k, v in _counts().items()
                                        if v and k.endswith("bf16")}
        solves[label] = res
        print(f"[bf16] {label} " + json.dumps(res), flush=True)
        g, c = res["cuda"], res["cpu"]
        if n == 40:
            if g["converged"] != c["converged"] or \
                    not g["launches"].get("stencil_tiled3d_bf16"):
                raise AssertionError(f"bf16 {label}: card against CPU {res}")
            continue
        band = max(2, 0.1 * c["iterations"])
        if abs(g["iterations"] - c["iterations"]) > band or \
                not g["converged"] or g["relres_true"] > 1e-8:
            raise AssertionError(f"bf16 {label}: card against CPU {res}")
        if n == 24 and not g["launches"].get("dia_matvec_bf16"):
            raise AssertionError(f"bf16 {label}: K2 in bf16 never launched")
    rows = []
    for name, (src, replaces) in BF16_KERNELS.items():
        levels = per_kernel[name]
        big = max(levels, key=lambda e: e["rows"])
        rows.append({
            "name": name, "path": "bf16", "route": "cuda", "source": src,
            "replaces": replaces, "launches": int(launches[name]),
            "max_abs_err": max(e["max_abs_err"] for e in levels),
            "ms": big["device_ms"], "device_ms": big["device_ms"],
            "cold_ms": big["cold_ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big["library_ms"], "variant": big["variant"],
            "levels": [
                {k: e[k] for k in ("level", "rows", "variant", "device_ms",
                                   "cold_ms", "bound_ms", "share_of_bound",
                                   "library_ms", "plain_ms",
                                   "f32_device_ms", "general_ms")
                 if k in e}
                for e in levels
            ],
        })
    print(f"[bf16] {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, solves


def _nodalp2_problem():
    """poisson_2d(32) viewed as P2 over the vertices at odd interior
    coordinates: (problem, (midnode, parent, parent) triples, vertex
    mask)."""
    from ngsamg_tpu_torch.utils import fem

    prob = fem.poisson_2d(32)
    m = 31
    idx = np.arange(m * m)
    pi, pj = idx // m + 1, idx % m + 1
    is_vert = (pi % 2 == 1) & (pj % 2 == 1)
    trips = []
    for t in np.flatnonzero(~is_vert):
        ti, tj = pi[t], pj[t]
        if ti % 2 == 0 and tj % 2:
            a, b = (ti - 1, tj), (ti + 1, tj)
        elif ti % 2:
            a, b = (ti, tj - 1), (ti, tj + 1)
        else:
            a, b = (ti - 1, tj - 1), (ti + 1, tj + 1)
        trips.append((t, (a[0] - 1) * m + a[1] - 1, (b[0] - 1) * m + b[1] - 1))
    return prob, np.asarray(trips, dtype=np.int64), is_vert


def phase_frontend_reference():
    """The front-end inputs on the card against the CPU, small sizes."""
    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.utils import fem

    t0 = time.perf_counter()
    cases = {}
    e = fem.elasticity_2d(8, length=6)
    fd = np.ones(e.n, dtype=bool)
    fd[np.random.default_rng(0).choice(e.n // 2, 10, replace=False) * 2 + 1] \
        = False
    idx = np.flatnonzero(fd)
    o = _options(dtype="float64")
    o.levels.max_coarse_size = 60
    cases["partial dirichlet"] = (e.A, e.A[idx][:, idx].tocsr(), e.b[idx], dict(
        energy="elasticity", block_size=2, coords=e.coords, freedofs=fd,
        options=o))
    base = fem.poisson_2d(32)
    vp = fem.vector_poisson(base, 2)
    inv = np.argsort((np.arange(2)[None, :] * base.n
                      + np.arange(base.n)[:, None]).ravel())
    Ac = vp.A[inv][:, inv].tocsr()
    cases["compound"] = (Ac, Ac, vp.b[inv], dict(
        block_size=2, coords=vp.coords, dof_layout="compound",
        options=_options()))
    q, dnums, elmats = fem.poisson_2d_elmats(32)
    cases["elmat"] = (q.A, q.A, q.b, dict(
        coords=q.coords, elmat_data=(dnums, elmats), options=_options()))
    q2, trips, is_vert = _nodalp2_problem()
    cases["nodalp2"] = (q2.A, q2.A, q2.b, dict(
        coords=q2.coords[is_vert], nodalp2=trips,
        options=_options(dtype="float64")))
    q3 = fem.poisson_3d(24)
    cases["do_test"] = (q3.A, q3.A, q3.b, dict(
        coords=q3.coords, options=_cheb_opts().replace(do_test=True)))
    out = {}
    for label, (A, A_ext, b_ext, kw) in cases.items():
        res = {}
        for dev in ("cuda", "cpu"):
            pc = AMGPreconditioner(A, device=dev, **kw).setup()
            x, info = pc.solve(b_ext, tol=1e-8)
            res[dev] = {
                "levels": [int(v) for v in pc.log_.nvs],
                "iterations": int(info.iterations),
                "relres_true": float(np.linalg.norm(b_ext - A_ext @ x)
                                     / np.linalg.norm(b_ext)),
                "bounds": list(pc.test(30)), "x": x,
            }
        g, c = res["cuda"], res["cpu"]
        diff = float(np.linalg.norm(g.pop("x") - c.pop("x"))
                     / np.linalg.norm(b_ext))
        out[label] = {**res, "x_diff_over_b": diff}
        bounds_ok = np.allclose(g["bounds"], c["bounds"], rtol=1e-2, atol=0)
        if g["levels"] != c["levels"] or \
                abs(g["iterations"] - c["iterations"]) > 1 or \
                g["relres_true"] > 1e-8 or not bounds_ok:
            raise AssertionError(f"frontend {label}: card against CPU "
                                 f"{out[label]}")
    print("[frontend-reference] " + json.dumps(out), flush=True)
    print(f"[frontend-reference] {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def _agg_labels(v2agg):
    """Each vertex's aggregate named by its first vertex (-1: none), so
    that two aggregations compare whatever their numbering."""
    v2agg = np.asarray(v2agg)
    ok = v2agg >= 0
    first = np.full(int(v2agg.max(initial=-1)) + 1, len(v2agg))
    np.minimum.at(first, v2agg[ok], np.flatnonzero(ok))
    return np.where(ok, first[np.where(ok, v2agg, 0)], -1)


def phase_device_pencils():
    """elasticity_3d(8) with the robust SOC's pencils on the card
    (``DEVICE_SOC_MIN_EDGES = 1``) against the default setup, whose robust
    SOC is the fused native kernel (``elast_soc_robust``); the largest
    pencil batch of the device setup in f64 on the host (the native
    ``pencil_extreme_eig``) and in f32 on the card."""
    import torch

    import ngsamg_tpu_torch.apps.elasticity as el
    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.ops import batched_la
    from ngsamg_tpu_torch.utils import fem

    t0 = time.perf_counter()
    q = fem.elasticity_3d(8)
    host_branch = el._pencil_extreme_eig
    batches = []

    def recording(E, C, **kw):
        batches.append((E, C, kw.get("reduction", "min")))
        return host_branch(E, C, **kw)

    runs, recorded = {}, {}
    el._pencil_extreme_eig = recording
    try:
        for label, min_edges in (("default", el.DEVICE_SOC_MIN_EDGES),
                                 ("device", 1)):
            el.DEVICE_SOC_MIN_EDGES = min_edges
            ts = time.perf_counter()
            pc = AMGPreconditioner(q.A, energy="elasticity", block_size=3,
                                   coords=q.coords, options=_cheb_opts(),
                                   device="cuda").setup()
            setup_s = time.perf_counter() - ts
            x, info = pc.solve(q.b, tol=1e-8, mixed=True)
            runs[label] = {
                "setup_host_s": setup_s,
                "level_sizes": [int(v) for v in pc.log_.nvs],
                "iterations": int(info.iterations),
                "relres_true": float(np.linalg.norm(q.b - q.A @ x)
                                     / np.linalg.norm(q.b)),
                "v2agg": [lev.v2agg for lev in pc.setup_levels_
                          if lev.v2agg is not None],
                "pencil_batches": len(batches),
            }
            recorded[label] = list(batches)
            batches.clear()
    finally:
        el._pencil_extreme_eig = host_branch
        el.DEVICE_SOC_MIN_EDGES = 10**9
    d, g = runs["default"], runs["device"]
    agree = [float(np.mean(_agg_labels(a) == _agg_labels(b)))
             if a.shape == b.shape else 0.0
             for a, b in zip(d.pop("v2agg"), g.pop("v2agg"))]
    # the largest pencil batch of the device setup, on both branches
    E, C, red = max(recorded["device"], key=lambda b: len(b[0]))
    t1 = time.perf_counter()
    ref = host_branch(E, C, reduction=red)
    host_s = time.perf_counter() - t1
    el.DEVICE_SOC_MIN_EDGES = 1
    try:
        host_branch(E, C, reduction=red, device="cuda")  # warm-up
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dev = host_branch(E, C, reduction=red, device="cuda")
        device_s = time.perf_counter() - t2
    finally:
        el.DEVICE_SOC_MIN_EDGES = 10**9
    Et = torch.as_tensor(E, dtype=torch.float32, device="cuda")
    Ct = torch.as_tensor(C, dtype=torch.float32, device="cuda")
    from ngsamg_tpu_torch.utils.timing import event_ms

    compute_ms = event_ms(lambda: batched_la.pencil_extreme_eig(
        Et, Ct, rel_tol=1e-6, reduction=red), reps=5)
    scale = max(float(np.abs(ref).max()), 1e-30)
    differ = int((np.abs(dev - ref) > 5e-3 * np.abs(ref) + 1e-4 * scale).sum())
    out = {"default": d, "device": g, "aggregates_agree": agree,
           "largest_batch": int(len(E)), "block": int(E.shape[-1]),
           "reduction": red, "host_s": host_s,
           "device_call_s": device_s, "device_compute_ms": compute_ms,
           "pencils_differ": differ, "s": time.perf_counter() - t0}
    print("[elasticity-reference] device pencils " + json.dumps(out),
          flush=True)
    if len(d["level_sizes"]) != len(g["level_sizes"]) or \
            g["relres_true"] > 1e-8 or d["relres_true"] > 1e-8:
        raise AssertionError(f"device pencils: {out}")
    return out


# the bench leg of the JAX package (bench.py:432-471): stokes_tri(20, dim=3,
# alpha=10) with geometric loops, max_coarse_size 80; its level sizes and
# iterations on the CPU, 18 in BENCH_r05.json too
STOKES_LEVELS = [104738, 46814, 19494, 6461, 1848, 475, 90, 10]
STOKES_MAX_IT = 19
STOKES_MAC_N = 512  # stokes_mac_2d(512): tree loops, Hiptmair on DIA A_pot
STOKES_MAC_DOFS = 523264
STOKES_MAC_LEVELS = 8
STOKES_MAC_JAX_IT = 409  # the JAX package's count on the CPU (3 passes)


def _stokes_amg(prob, mcs, device="cuda", geometric=True, dist_setup=0):
    """A StokesAMG of a stokes_fem problem with ``max_coarse_size`` mcs
    (not set up); ``geometric`` passes the primal facet -> vertex
    incidence (short loops) where the problem has one."""
    from ngsamg_tpu_torch import AMGOptions
    from ngsamg_tpu_torch.precond.stokes import StokesAMG

    opts = AMGOptions(dist_setup=dist_setup)
    opts.levels.max_coarse_size = mcs
    kw = {}
    if geometric and prob.facet_verts is not None:
        kw = dict(facet_verts=prob.facet_verts, vert_pos=prob.vert_pos,
                  bnd_facet_verts=prob.bnd_facet_verts)
    return StokesAMG(
        prob.A, cell_pos=prob.cell_pos, cell_vol=prob.cell_vol,
        facet_cells=prob.facet_cells, facet_flow=prob.facet_flow,
        options=opts, device=device, **kw,
    )


def _true_relres(A, b, x) -> float:
    x = np.asarray(x)
    if x.shape != (A.shape[0],) or not np.isfinite(x).all():
        raise AssertionError(f"solution shape {x.shape} or not finite")
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def _stokes_solves(pc, prob, maxiter, warm, first=True):
    """A first solve (unless ``first`` is false: the port compiles nothing
    at run time, so on a card that earlier phases have used the first
    solve is a warm one) and ``warm`` warm solves, the launch counters read
    over the first warm one; the wall clocks end in a synchronize."""
    import torch

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = pc.solve(prob.b, tol=1e-8, maxiter=maxiter)
        torch.cuda.synchronize()
        return x, info, time.perf_counter() - t0

    first_s = run()[2] if first else None
    walls = []
    for k in range(warm):
        if k == 0:
            _reset_counts()
        x, info, w = run()
        walls.append(w)
        if k == 0:
            launches = _counts()
    relres = _true_relres(prob.A, prob.b, x)
    out = {
        "iterations": int(info.iterations),
        "outer_iterations": int(info.outer_iterations),
        "relres_true": relres,
        "first_solve_s": first_s,
        "warm_solves_s": walls,
        "warm_solve_s": float(np.median(walls)),
        "kernel_launches_warm": {k: v for k, v in launches.items() if v},
    }
    if not info.converged or relres > 1e-8:
        raise AssertionError(f"not converged: solver relres {info.relres}, "
                             f"true {relres}")
    off_card = [lab for lab, t in _operator_tensors(pc.op)
                if t.device.type != "cuda"]
    if off_card:
        raise AssertionError(f"not on the card: {off_card[:5]}")
    return out


def phase_stokes():
    """The JAX package's Stokes bench leg on the card: assembly, host
    setup, staging, the maxiter=8 warm-up, first and warm solves, and the
    device kernels of one warm solve (torch.profiler)."""
    from ngsamg_tpu_torch.utils.stokes_fem import stokes_tri

    t0 = time.perf_counter()
    prob, _normals = stokes_tri(20, dim=3, alpha=10.0)
    t1 = time.perf_counter()
    pc = _stokes_amg(prob, 80).setup()
    t2 = time.perf_counter()
    pc.solve(prob.b, tol=1e-8, maxiter=8)  # the bench's warm-up
    t3 = time.perf_counter()
    out = {
        "dofs": int(prob.n),
        "level_sizes": [int(c.A.shape[0]) for c in pc.setup_levels_],
        "level_formats": [type(lev.A).__name__ for lev in pc.op.levels],
        "smoothers": [type(lev.smoother).__name__ for lev in pc.op.levels],
        "assembly_s": t1 - t0,
        "setup_host_s": pc.setup_time_host,
        "setup_staging_s": pc.setup_time_device,
        "warmup_maxiter8_s": t3 - t2,
    }
    out.update(_stokes_solves(pc, prob, 150, warm=3))
    out["profiled_launches_warm"] = _profiled_launches(
        lambda: pc.solve(prob.b, tol=1e-8, maxiter=150))
    print("[stokes] " + json.dumps(out), flush=True)
    if out["level_sizes"] != STOKES_LEVELS:
        raise AssertionError(f"stokes: levels {out['level_sizes']} != "
                             f"{STOKES_LEVELS}")
    if out["iterations"] > STOKES_MAX_IT:
        raise AssertionError(f"stokes: {out['iterations']} iterations > "
                             f"{STOKES_MAX_IT}")
    return out


def _k2_row(cases, launches, path, tag, seed):
    """K2 against its plain version on each ``(level, A)`` of ``cases``
    (full-storage DIA levels), timed like phase 4; returns the
    kernels-line row of ``path``, its launches those of the path's warm
    solve."""
    import torch

    from ngsamg_tpu_torch.ops import dia_cuda
    from ngsamg_tpu_torch.utils.timing import cold_ms, event_ms, graph_ms

    kern, plain = dia_cuda.dia_matvec, dia_cuda._dia_matvec_plain
    levels = []
    for lvl, A in cases:
        label = f"dia_matvec_f32 {tag} level {lvl}"
        x = _rand_x(A.nrows, A.nrows_pad, torch.float32, seed + lvl)
        err, rel = _check_kernel(A, x, kern, plain, F32_TOL, label)
        _same_bits(kern, A, x, label)
        nbytes, flops = _level_cost(A, torch.float32)
        bound_ms, bound_by = _bound_ms(nbytes, flops, torch.float32)
        lib = _csr_call(A, x)
        entry = {
            "level": lvl, "rows": A.nrows, "terms": len(A.offsets),
            "reach": max(abs(int(o)) for o in A.offsets),
            "variant": _variant(A), "window": A.launch.plan.window,
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "rel_err": rel,
            "device_ms": graph_ms(lambda: kern(A, x)),
            "cold_ms": cold_ms(lambda: kern(A, x)),
            "call_ms": event_ms(lambda: kern(A, x)),
            "plain_ms": graph_ms(lambda: plain(A, x), n=5),
            "library_ms": graph_ms(lib),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        del lib
        entry["share_of_bound"] = bound_ms / entry["device_ms"]
        print(f"[{path}] K2 " + json.dumps(entry), flush=True)
        levels.append(entry)
    if not levels:
        raise AssertionError(f"{path}: no full-storage DIA level")
    big = max(levels, key=lambda e: e["rows"])
    src, replaces = KERNELS["dia_matvec_f32"]
    return {
        "name": "dia_matvec_f32", "path": path, "route": "cuda",
        "source": src, "replaces": replaces,
        "launches": int(launches["dia_matvec_f32"]),
        "max_abs_err": max(e["max_abs_err"] for e in levels),
        "ms": big["device_ms"], "device_ms": big["device_ms"],
        "cold_ms": big["cold_ms"], "call_ms": big["call_ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": big["library_ms"],
        "variant": big["variant"],
        "levels": [
            {k: e[k] for k in ("level", "rows", "terms", "reach", "variant",
                               "device_ms", "cold_ms", "call_ms",
                               "bound_ms", "share_of_bound", "library_ms",
                               "plain_ms")}
            for e in levels
        ],
    }


def _stokes_k2_levels(pc, launches):
    """K2 on every DIA potential-space operator of a Stokes hierarchy."""
    from ngsamg_tpu_torch.sparse import formats

    cases = []
    for lvl, lev in enumerate(pc.op.levels):
        A = getattr(lev.smoother, "A_pot", None)
        if isinstance(A, formats.DiaMatrix) and not A.sym_half:
            cases.append((lvl, A))
    return _k2_row(cases, launches, "stokes-mac", "stokes-mac A_pot", 300)


def phase_stokes_mac():
    """stokes_mac_2d(512) on the card: tree loops and Hiptmair smoothing
    whose potential-space operators are DIA (K2 at offsets up to
    +-1,022); one warm solve from counters at 0 (its time and K2
    launches), the device kernels of one cycle (torch.profiler), and K2
    against its plain version on every DIA potential-space level."""
    import torch

    from ngsamg_tpu_torch.precond.amg import _full_f32
    from ngsamg_tpu_torch.solve.cycle import amg_apply
    from ngsamg_tpu_torch.utils.stokes_fem import stokes_mac_2d

    t0 = time.perf_counter()
    prob = stokes_mac_2d(STOKES_MAC_N)
    t1 = time.perf_counter()
    pc = _stokes_amg(prob, 80).setup()
    out = {
        "dofs": int(prob.n),
        "level_sizes": [int(c.A.shape[0]) for c in pc.setup_levels_],
        "level_formats": [type(lev.A).__name__ for lev in pc.op.levels],
        "a_pot": [
            [type(lev.smoother.A_pot).__name__, int(lev.smoother.A_pot.nrows),
             len(getattr(lev.smoother.A_pot, "offsets", ()))]
            for lev in pc.op.levels if hasattr(lev.smoother, "A_pot")
        ],
        "assembly_s": t1 - t0,
        "setup_host_s": pc.setup_time_host,
        "setup_staging_s": pc.setup_time_device,
    }
    out.update(_stokes_solves(pc, prob, 1000, warm=1, first=False))
    r = pc._to_dev(prob.b)
    with _full_f32():
        out["profiled_launches_one_cycle"] = _profiled_launches(
            lambda: amg_apply(pc.op, r))
    torch.cuda.synchronize()
    print("[stokes-mac] " + json.dumps(out), flush=True)
    if out["dofs"] != STOKES_MAC_DOFS or pc.num_levels != STOKES_MAC_LEVELS:
        raise AssertionError(f"stokes-mac: {out['dofs']} DoF in "
                             f"{pc.num_levels} levels")
    if abs(out["iterations"] - STOKES_MAC_JAX_IT) > 0.05 * STOKES_MAC_JAX_IT:
        raise AssertionError(f"stokes-mac: {out['iterations']} iterations, "
                             f"the JAX package's {STOKES_MAC_JAX_IT}")
    if out["kernel_launches_warm"].get("dia_matvec_f32", 0) <= 0:
        raise AssertionError("stokes-mac: K2 never launched")
    row = _stokes_k2_levels(pc, out["kernel_launches_warm"])
    return out, row


def _stokes_reference_problems():
    """(label, maker) of the card-against-CPU problems: HDiv 2D and 3D,
    HDG-embedded 2D and the vector CR facet space (StokesAMG)."""
    from ngsamg_tpu_torch import AMGOptions
    from ngsamg_tpu_torch.precond.stokes import (
        StokesHDGEmbeddedAMG, StokesHDivAMG)
    from ngsamg_tpu_torch.utils import stokes_fem as sf

    def opts(mcs):
        o = AMGOptions()
        o.levels.max_coarse_size = mcs
        return o

    def hdiv(n, dim, mcs):
        def build(device):
            prob, counts, V = sf.stokes_tri_hdiv(n, dim=dim)
            pc = StokesHDivAMG(
                prob.A, cell_pos=prob.cell_pos, cell_vol=prob.cell_vol,
                facet_cells=prob.facet_cells, facet_flow=prob.facet_flow,
                facet_dof_counts=counts, preserved=V, options=opts(mcs),
                device=device)
            return pc, prob.A, prob.b
        return build

    def hdg(device):
        S, b, E, geo = sf.stokes_hdg_p1(12)
        return StokesHDGEmbeddedAMG(S, E, **geo, options=opts(150),
                                    device=device), S, b

    def cr(device):
        prob, _normals = sf.stokes_cr(10, dim=2)
        return _stokes_amg(prob, 150, device, geometric=False), prob.A, prob.b

    return [("hdiv_2d", hdiv(14, 2, 120)), ("hdiv_3d", hdiv(5, 3, 250)),
            ("hdg_2d", hdg), ("cr_2d", cr)]


def phase_stokes_reference():
    """Card against CPU on the small HDiv, HDG and CR problems: iterations
    within one, solutions to 1e-6 relative, true relres <= 1e-8."""
    t0 = time.perf_counter()
    out = {}
    for label, build in _stokes_reference_problems():
        res = {}
        for dev in ("cuda", "cpu"):
            pc, A, b = build(dev)
            pc.setup()
            x, info = pc.solve(b, tol=1e-8, maxiter=500)
            res[dev] = (x, info, _true_relres(A, b, x), pc.num_levels)
        (xg, ig, relg, lg), (xc, ic, _relc, lc) = res["cuda"], res["cpu"]
        diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
        out[label] = {"dofs": int(A.shape[0]), "levels": lg,
                      "card_iterations": int(ig.iterations),
                      "cpu_iterations": int(ic.iterations),
                      "card_relres_true": relg, "x_diff": diff}
        if (abs(ig.iterations - ic.iterations) > 1 or not ig.converged
                or relg > 1e-8 or lg != lc or diff > 1e-6):
            raise AssertionError(f"stokes-reference {label}: the card "
                                 f"disagrees with the CPU: {out[label]}")
    print("[stokes-reference] " + json.dumps(out), flush=True)
    print(f"[stokes-reference] {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# the JAX package's distributed setup on poisson_3d(101) (SPW, Chebyshev,
# dist_setup=8; its numbers on the CPU, measured when the slice was
# specified): levels, operator complexity, contraction decisions
DIST_SHARDS = 8
DIST_LEVELS = [1000000, 147697, 39687, 10660, 2872, 776, 208]
DIST_OC = 2.7298
DIST_CONTRACT = [(3, 8, 2, "min_rows"), (4, 2, 1, "min_rows")]
DIST_SHARDS_PER_LEVEL = [8, 8, 8, 2, 1, 1, 1]
DIST_JAX_IT = 16
# PR 9's staging of that hierarchy on one device (bucketed tile-ELL) and
# the sharded solve's (shards=8: plain tile-ELL, every level padded to a
# multiple of 64 rows)
DIST_FORMATS = ["DiaMatrix"] + ["TileELLStack"] * 3 + ["DenseMatrix"] * 3
# the native wrappers the JAX package's native run reaches through the
# distributed setup and its staging (the CPU test's h1_dist problem)
DIST_NATIVE_WRAPPERS = (
    "truncate_prol_blocks", "csr_permute", "csr_sym_scale",
    "tile_chunk_counts", "tile_ell_fill_range", "tile_ell_pack",
    "cluster_detect",
)
DIST_NUMPY_RECORD = {"setup_host_s": [22.353, 27.849],
                     "setup_staging_s": [10.322, 11.879]}
SHARDED_FORMATS = ["DiaMatrix"] + ["TileELL"] * 3 + ["DenseMatrix"] * 3
# ... and on unstructured_elasticity(140, dim=2), max_coarse_size 60
DIST_ELAST_N = 140
DIST_ELAST_LEVELS = [19740, 3051, 862, 242, 67, 18]
DIST_ELAST_OC = 2.276
DIST_ELAST_CONTRACT = [(1, 8, 1, "min_rows")]
DIST_ELAST_SHARDS_PER_LEVEL = [8, 1, 1, 1, 1, 1]
DIST_ELAST_JAX_IT = 21
MP_RANKS = 4
MP_N = 41  # fem.poisson_3d(41): 64,000 DoF


def _dist_opts(mcs=None, **kw):
    """The distributed setup's options: Chebyshev, SPW coarsening on 8
    shards."""
    from ngsamg_tpu_torch import CoarsenType, SpecOpt

    opts = _options("chebyshev", dist_setup=DIST_SHARDS, **kw)
    opts.coarsen.algo = SpecOpt(CoarsenType.SPW)
    if mcs is not None:
        opts.levels.max_coarse_size = mcs
    return opts


def _dist_log(log) -> dict:
    return {
        "contract_decisions": [list(d) for d in log.contract_decisions],
        "shards_per_level": list(log.shards_per_level),
        "peak_shard_bytes": int(log.peak_shard_bytes),
        "finest_global_bytes": int(log.finest_global_bytes),
    }


def _check_dist_log(label, out, levels, oc, contract, shards, digits):
    if out["level_sizes"] != levels:
        raise AssertionError(f"{label}: levels {out['level_sizes']} != "
                             f"{levels}")
    if round(out["operator_complexity"], digits) != oc:
        raise AssertionError(f"{label}: operator complexity "
                             f"{out['operator_complexity']} != {oc}")
    if [tuple(d) for d in out["contract_decisions"]] != contract:
        raise AssertionError(f"{label}: contract decisions "
                             f"{out['contract_decisions']} != {contract}")
    if out["shards_per_level"] != shards:
        raise AssertionError(f"{label}: shards per level "
                             f"{out['shards_per_level']} != {shards}")


def phase_dist_setup(p):
    """poisson_3d(101) through the host-distributed setup on 8 shards
    (SPW, Chebyshev) on the card: the JAX package's levels, operator
    complexity and contraction decisions; level 0 a full DIA on K2's
    read-only-cache plan; then K2 at that level against its plain
    version, timed."""
    from ngsamg_tpu_torch.sparse import formats

    pc, out = _solve_run(p, _dist_opts(), "dist-setup")
    out.update(_dist_log(pc.log_))
    A0 = pc.op.levels[0].A
    out["level0"] = {"format": type(A0).__name__,
                     "sym_half": bool(getattr(A0, "sym_half", False)),
                     "offsets": list(getattr(A0, "offsets", ())),
                     "plan": _variant(A0) if hasattr(A0, "launch") else None}
    out["setup_numpy_record"] = DIST_NUMPY_RECORD
    out["card"] = _nvidia_smi()
    print("[dist-setup] " + json.dumps(out), flush=True)
    _check_native("dist-setup", out["native_calls"], DIST_NATIVE_WRAPPERS)
    _check_dist_log("dist-setup", out, DIST_LEVELS, DIST_OC, DIST_CONTRACT,
                    DIST_SHARDS_PER_LEVEL, 4)
    if not out["peak_shard_bytes"] < 4 * out["finest_global_bytes"] \
            / DIST_SHARDS:
        raise AssertionError(f"dist-setup: peak shard bytes "
                             f"{out['peak_shard_bytes']} not under 4/8 of "
                             f"{out['finest_global_bytes']}")
    if abs(out["iterations"] - DIST_JAX_IT) > 1:
        raise AssertionError(f"dist-setup: {out['iterations']} iterations, "
                             f"the JAX package's {DIST_JAX_IT}")
    if not isinstance(A0, formats.DiaMatrix) or A0.sym_half \
            or A0.launch.plan.path != "ldg":
        raise AssertionError(f"dist-setup: level 0 is {out['level0']}, not "
                             "a full DIA on K2's ldg plan")
    if out["level_formats"] != DIST_FORMATS:
        raise AssertionError(f"dist-setup: formats {out['level_formats']} "
                             f"!= {DIST_FORMATS}")
    if out["kernel_launches_warm"]["dia_matvec_f32"] <= 0:
        raise AssertionError("dist-setup: K2 never launched")
    row = _k2_row([(0, A0)], out["kernel_launches_warm"], "dist",
                  "dist-setup", 400)
    return pc, out, row


def phase_dist_elasticity():
    """unstructured_elasticity(140, dim=2) through the distributed
    elasticity setup (dist_setup=8) on the card and on the CPU, solved
    with plain f32 defect correction (the JAX package's measurement) and
    with the mixed-precision PCG."""
    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.utils import fem

    t0 = time.perf_counter()
    q = fem.unstructured_elasticity(DIST_ELAST_N, dim=2)
    pcs, runs = {}, {}
    for dev in ("cuda", "cpu"):
        pcs[dev] = AMGPreconditioner(
            q.A, energy="elasticity", block_size=2, coords=q.coords,
            options=_dist_opts(mcs=60), device=dev,
        ).setup()
        for mixed in (False, True):
            x, info = pcs[dev].solve(q.b, tol=1e-8, mixed=mixed)
            x = np.asarray(x)
            runs[dev, mixed] = {
                "iterations": int(info.iterations),
                "outer_iterations": int(info.outer_iterations),
                "history": [float(h) for h in info.history],
                "relres_true": _true_relres(q.A, q.b, x),
                "converged": bool(info.converged), "x": x,
            }
    pg = pcs["cuda"]
    out = {"dofs": int(q.n), "level_sizes": [int(v) for v in pg.log_.nvs],
           "operator_complexity": pg.operator_complexity,
           "level_formats": [type(lev.A).__name__ for lev in pg.op.levels],
           "setup_host_s": pg.setup_time_host,
           "setup_staging_s": pg.setup_time_device}
    out.update(_dist_log(pg.log_))
    for (dev, mixed), r in runs.items():
        out[f"{dev}_{'mixed' if mixed else 'plain'}"] = {
            k: v for k, v in r.items() if k != "x"}
    for mixed in (False, True):
        xg, xc = runs["cuda", mixed]["x"], runs["cpu", mixed]["x"]
        out[f"x_diff_{'mixed' if mixed else 'plain'}"] = float(
            np.linalg.norm(xg - xc) / np.linalg.norm(xc))
    out["s"] = time.perf_counter() - t0
    print("[dist-elasticity] " + json.dumps(out), flush=True)
    _check_dist_log("dist-elasticity", out, DIST_ELAST_LEVELS,
                    DIST_ELAST_OC, DIST_ELAST_CONTRACT,
                    DIST_ELAST_SHARDS_PER_LEVEL, 3)
    if pcs["cpu"].log_.nvs != pg.log_.nvs:
        raise AssertionError("dist-elasticity: CPU levels differ")
    if abs(runs["cpu", False]["iterations"] - DIST_ELAST_JAX_IT) > 1:
        raise AssertionError(f"dist-elasticity: the CPU's plain count "
                             f"{runs['cpu', False]['iterations']}, the JAX "
                             f"package's {DIST_ELAST_JAX_IT}")
    # plain f32 defect correction stalls at the f32 floor in each pass and
    # where a pass stops follows the rounding: the 10% band of
    # [gs-reference]'s plain elasticity solve; the mixed PCG within one
    bands = {False: max(2, 0.1 * runs["cpu", False]["iterations"]),
             True: 1}
    for mixed, band in bands.items():
        g, c = runs["cuda", mixed], runs["cpu", mixed]
        diff = out[f"x_diff_{'mixed' if mixed else 'plain'}"]
        if (abs(g["iterations"] - c["iterations"]) > band
                or not g["converged"] or g["relres_true"] > 1e-8
                or c["relres_true"] > 1e-8 or diff > 1e-6):
            raise AssertionError(f"dist-elasticity: the card disagrees with "
                                 f"the CPU (mixed={mixed})")
    return q, out


def _levels_bitwise(label, ref, got):
    if len(ref) != len(got):
        raise AssertionError(f"{label}: {len(got)} levels, not {len(ref)}")
    for i, (a, b) in enumerate(zip(ref, got)):
        mats = [(a.A, b.A)]
        if a.P is not None or b.P is not None:
            mats.append((a.P, b.P))
        if a.P_amg is not None or b.P_amg is not None:
            mats.append((a.P_amg, b.P_amg))
        for ma, mb in mats:
            ma, mb = ma.tocsr(), mb.tocsr()
            if not (np.array_equal(ma.indptr, mb.indptr)
                    and np.array_equal(ma.indices, mb.indices)
                    and np.array_equal(ma.data, mb.data)):
                raise AssertionError(f"{label}: level {i} differs")
        if a.v2agg is not None and not np.array_equal(a.v2agg, b.v2agg):
            raise AssertionError(f"{label}: level {i} aggregates differ")


def phase_mp_setup(q_elast):
    """mp_dist_setup_levels on 4 rank processes (the card hidden from
    them): bitwise the single controller's hierarchy on poisson_3d(41) and
    on the dist-elasticity problem; the scalar MP hierarchy staged on the
    card and solved."""
    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.apps.elasticity import ElasticityEnergy
    from ngsamg_tpu_torch.apps.h1 import H1Energy
    from ngsamg_tpu_torch.parallel.dist_setup import dist_setup_levels
    from ngsamg_tpu_torch.parallel.mp_runtime import mp_dist_setup_levels
    from ngsamg_tpu_torch.utils import fem

    p = fem.poisson_3d(MP_N)
    out, mp = {}, {}
    for label, A, energy, opts, coords in (
        ("poisson_3d(41)", p.A, lambda: H1Energy(bs=1), _dist_opts(), None),
        (f"unstructured_elasticity({DIST_ELAST_N}, 2)", q_elast.A,
         lambda: ElasticityEnergy(dim=2), _dist_opts(mcs=60),
         q_elast.coords),
    ):
        t0 = time.perf_counter()
        ref, _ref_log = dist_setup_levels(A, energy(), opts, MP_RANKS,
                                          coords=coords)
        t1 = time.perf_counter()
        levels, log = mp_dist_setup_levels(A, energy(), opts, MP_RANKS,
                                           coords=coords)
        t2 = time.perf_counter()
        _levels_bitwise(f"mp-setup {label}", ref, levels)
        out[label] = {
            "dofs": int(A.shape[0]), "level_sizes": list(log.nvs),
            "single_controller_s": t1 - t0, "mp_s": t2 - t1,
            "ranks": [{k: st[k] for k in ("peak_shard_bytes",
                                          "transport_calls", "moved_bytes",
                                          "native_calls")}
                      for st in log.mp_rank_stats],
        }
        mp[label] = (levels, log)
        # a scalar rank's level loop and an elasticity rank's both truncate
        # P in the native kernel
        if not all(
                st["native_calls"].get("truncate_prol_blocks", {}).get(
                    "native") for st in log.mp_rank_stats):
            raise AssertionError(f"mp-setup {label}: a rank made no native "
                                 f"call: {out[label]['ranks']}")
    pc = AMGPreconditioner(p.A, coords=p.coords, options=_dist_opts(),
                           device="cuda")
    pc.setup_levels_, pc.log_ = mp["poisson_3d(41)"]
    pc._compile_device()
    pc._is_setup = True
    x, info = pc.solve(p.b, tol=1e-8)
    relres = _true_relres(p.A, p.b, x)
    off_card = [lab for lab, t in _operator_tensors(pc.op)
                if t.device.type != "cuda"]
    out["mp_solve"] = {"iterations": int(info.iterations),
                       "relres_true": relres,
                       "level_formats": [type(lev.A).__name__
                                         for lev in pc.op.levels]}
    print("[mp-setup] " + json.dumps(out), flush=True)
    if off_card or not info.converged or relres > 1e-8:
        raise AssertionError(f"mp-setup: MP hierarchy solve {out['mp_solve']}"
                             f", off the card: {off_card[:5]}")
    return out


def _device_y(A, v):
    """A staged level's matvec of a host vector, back on the host in f64."""
    import torch

    from ngsamg_tpu_torch.sparse import formats

    xb = formats.block_vec(v, 1, A.nrows_pad, torch.float32, device="cuda")
    return formats.flat_vec(formats.matvec(A, xb), A.nrows).double() \
        .cpu().numpy()


def phase_api(p):
    """The headline through ``api.h1_scal`` on the card: levels, operator
    complexity, iterations and K1-K3 launched in its solve; the
    introspection methods (GetNDof, GetOC, CINV, ToSparseMatrix of levels
    1-5 against each level's device matvec) and GetBF's refusal across
    the implicit lattice transfer."""
    import torch

    from ngsamg_tpu_torch import api

    t0 = time.perf_counter()
    pc = api.h1_scal(p.A, coords=p.coords, ngs_amg_sm_type="chebyshev")
    t1 = time.perf_counter()
    _reset_counts()
    x, info = pc.solve(p.b, tol=1e-8, return_device=True)
    torch.cuda.synchronize()
    launches = _counts()
    relres = _true_relres(p.A, p.b, x.cpu().numpy())
    nlev = pc.GetNLevels()
    rng = np.random.default_rng(21)
    to_sparse = []
    for lvl in range(1, nlev):
        A = pc.op.levels[lvl].A
        C = api.ToSparseMatrix(A)
        v = rng.standard_normal(C.shape[0])
        y = _device_y(A, v)
        to_sparse.append({
            "level": lvl, "format": type(A).__name__,
            "sym_half": bool(getattr(A, "sym_half", False)),
            "nnz": int(C.nnz),
            "rel_err": float(np.abs(C @ v - y).max() / np.abs(y).max()),
        })
    Ac = pc.setup_levels_[-1].A
    c = rng.standard_normal(Ac.shape[0])
    cinv_err = float(np.linalg.norm(Ac @ pc.CINV(c) - c) / np.linalg.norm(c))
    try:
        pc.GetBF(level=2)
        getbf = None
    except ValueError as e:
        getbf = str(e)
    out = {"ndof": [pc.GetNDof(i) for i in range(nlev)], "oc": pc.GetOC(),
           "iterations": int(info.iterations), "relres_true": relres,
           "setup_s": t1 - t0, "cinv_rel_err": cinv_err,
           "to_sparse": to_sparse, "getbf_level2": getbf,
           "launches": {k: v for k, v in launches.items() if v}}
    print("[api] " + json.dumps(out), flush=True)
    if out["ndof"] != HEADLINE_LEVELS or round(out["oc"], 3) != 1.762:
        raise AssertionError(f"api: levels {out['ndof']}, OC {out['oc']}")
    if info.iterations > 15 or not info.converged or relres > 1e-8:
        raise AssertionError(f"api: {info.iterations} iterations, relres "
                             f"{relres}")
    for k in _path_kernels(pc):
        if launches[k] <= 0:
            raise AssertionError(f"api: kernel {k} never launched")
    if any(e["rel_err"] > 1e-5 for e in to_sparse) \
            or not all(e["sym_half"] for e in to_sparse[:2]):
        raise AssertionError(f"api: ToSparseMatrix {to_sparse}")
    if cinv_err > 1e-8:
        raise AssertionError(f"api: CINV residual {cinv_err}")
    if getbf is None or "implicit (lattice transfer)" not in getbf:
        raise AssertionError(f"api: GetBF(level=2) gave {getbf!r}")
    return pc, launches


def phase_api_reference():
    """The api on small problems, card against CPU: h1_scal (defaults,
    GS) with GetBF, the DOFMap and ToSparseMatrix of every level,
    elast_3d with GetRotationOfBF, h1_3d on a 3-component vector Poisson,
    the five standalone smoothers, and one Stokes class of each kind."""
    from ngsamg_tpu_torch import api
    from ngsamg_tpu_torch.utils import fem
    from ngsamg_tpu_torch.utils import stokes_fem as sf

    t0 = time.perf_counter()
    out = {}

    def solved(pc, A, b, **kw):
        x, info = pc.solve(b, tol=1e-8, **kw)
        x = np.asarray(x)
        return x, int(info.iterations), _true_relres(A, b, x)

    def compare(label, runs, extra=None):
        (xg, ig, rg), (xc, ic, _rc) = runs["cuda"], runs["cpu"]
        diff = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
        out[label] = {"card_iterations": ig, "cpu_iterations": ic,
                      "card_relres_true": rg, "x_diff": diff,
                      **(extra or {})}
        if abs(ig - ic) > 1 or rg > 1e-8 or diff > 1e-6:
            raise AssertionError(f"api-reference {label}: {out[label]}")

    p = fem.poisson_2d(24)
    pcs = {dev: api.h1_scal(p.A, coords=p.coords, ngs_amg_max_coarse_size=40,
                            device=dev) for dev in ("cuda", "cpu")}
    g, c = pcs["cuda"], pcs["cpu"]
    vf = np.random.default_rng(22).standard_normal(p.n)
    mg, mc = g.GetMap(), c.GetMap()
    for k in range(mg.GetNSteps()):
        vc = mg.TransferF2C(k, vf)
        if not (np.allclose(vc, mc.TransferF2C(k, vf), rtol=1e-6)
                and np.allclose(mg.TransferC2F(k, vc), mc.TransferC2F(k, vc),
                                rtol=1e-6)):
            raise AssertionError(f"api-reference: DOFMap step {k} differs")
        vf = vc
    for lvl in range(1, g.GetNLevels()):
        if not np.allclose(g.GetBF(level=lvl, dof=1), c.GetBF(level=lvl, dof=1),
                           rtol=1e-6):
            raise AssertionError(f"api-reference: GetBF level {lvl} differs")
    for lvl, (lg, lc) in enumerate(zip(g.op.levels, c.op.levels)):
        if (api.ToSparseMatrix(lg.A) != api.ToSparseMatrix(lc.A)).nnz:
            raise AssertionError(f"api-reference: ToSparseMatrix level {lvl}")
    compare("h1_scal poisson_2d(24)",
            {dev: solved(pcs[dev], p.A, p.b) for dev in pcs},
            {"levels": g.GetNLevels(), "steps": mg.GetNSteps()})

    e = fem.elasticity_3d(8)
    pcs = {dev: api.elast_3d(e.A, e.coords,
                             ngs_amg_sm_type="chebyshev", device=dev)
           for dev in ("cuda", "cpu")}
    rot = [pcs[dev].GetRotationOfBF(level=1, dof=2, comp=4)
           for dev in ("cuda", "cpu")]
    if rot[0].shape != (e.n // 3, 3) or not np.allclose(rot[0], rot[1],
                                                         rtol=1e-6):
        raise AssertionError("api-reference: GetRotationOfBF differs")
    compare("elast_3d elasticity_3d(8), mixed",
            {dev: solved(pcs[dev], e.A, e.b, mixed=True) for dev in pcs})

    v = fem.vector_poisson(fem.poisson_3d(12), 3)
    compare("h1_3d vector_poisson(poisson_3d(12), 3)", {
        dev: solved(api.h1_3d(v.A, coords=v.coords, device=dev), v.A, v.b)
        for dev in ("cuda", "cpu")})

    s = fem.poisson_3d(24)
    rng = np.random.default_rng(23)
    x0, b = rng.standard_normal(s.n), rng.standard_normal(s.n)
    blocks = [np.arange(i, min(i + 4, s.n)) for i in range(0, s.n, 4)]
    smoothers = {
        "CreateHybridGSS": lambda d: api.CreateHybridGSS(s.A, device=d),
        "CreateJacobiSmoother": lambda d: api.CreateJacobiSmoother(
            s.A, device=d),
        "CreateChebyshevSmoother": lambda d: api.CreateChebyshevSmoother(
            s.A, device=d),
        "CreateDynBlockSmoother": lambda d: api.CreateDynBlockSmoother(
            s.A, device=d),
        "CreateHybridBlockGSS": lambda d: api.CreateHybridBlockGSS(
            s.A, blocks, device=d),
    }
    sm_err = {}
    for name, make in smoothers.items():
        sg, sc = make("cuda"), make("cpu")
        for fn in ("Smooth", "SmoothBack"):
            yg, yc = getattr(sg, fn)(x0, b), getattr(sc, fn)(x0, b)
            err = float(np.abs(yg - yc).max() / np.abs(yc).max())
            sm_err[f"{name}.{fn}"] = err
            if err > 1e-5:
                raise AssertionError(f"api-reference: {name}.{fn} {err}")
    out["smoothers_rel_err"] = sm_err

    def stokes_opts(mcs):
        from ngsamg_tpu_torch import AMGOptions

        o = AMGOptions()
        o.levels.max_coarse_size = mcs
        return o

    def geo(prob):
        return dict(cell_pos=prob.cell_pos, cell_vol=prob.cell_vol,
                    facet_cells=prob.facet_cells, facet_flow=prob.facet_flow)

    prob, counts, V = sf.stokes_tri_hdiv(14)
    compare("stokes_hdiv_gg_2d stokes_tri_hdiv(14)", {
        dev: solved(api.stokes_hdiv_gg_2d(
            prob.A, **geo(prob), facet_dof_counts=counts, preserved=V,
            options=stokes_opts(120), device=dev), prob.A, prob.b)
        for dev in ("cuda", "cpu")})
    S, bs_, E, hg = sf.stokes_hdg_p1(12)
    compare("stokes_hdg_gg_2d stokes_hdg_p1(12)", {
        dev: solved(api.stokes_hdg_gg_2d(S, E, **hg,
                                         options=stokes_opts(150),
                                         device=dev), S, bs_)
        for dev in ("cuda", "cpu")})
    cr, _normals = sf.stokes_cr(10, dim=2)
    compare("stokes_gg_2d stokes_cr(10)", {
        dev: solved(api.stokes_gg_2d(cr.A, **geo(cr),
                                     options=stokes_opts(150), device=dev),
                    cr.A, cr.b)
        for dev in ("cuda", "cpu")})
    out["s"] = time.perf_counter() - t0
    print("[api-reference] " + json.dumps(out), flush=True)
    return out


def phase_timers(pc, p):
    """One warm headline solve with tracing on under ``torch.profiler``,
    written through ``Recorder.export_chrome``: the merged trace holds the
    program's ``cycle.level`` spans on their host track and K1's tiled
    kernel, and the spans add no device event."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ngsamg_tpu_torch.utils import timers

    rec = pc.trace_
    n0 = len(rec.spans)
    with timers.tracing(True), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _x, info = pc.solve(p.b, tol=1e-8, return_device=True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        path = os.path.join(logdir, "solve.json")
        rec.export_chrome(path, prof)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        size = os.path.getsize(path)
    spans = [e for e in events if e.get("cat") == "ngsamg_span"]
    names = {str(e.get("name")) for e in events}
    k1 = sorted(n for n in names if "stencil3d_kernel" in n)
    levels = sorted({e["args"]["level"] for e in spans
                     if e["name"] == "cycle.level"})
    out = {"trace_bytes": size, "events": len(events),
           "spans": len(spans), "spans_recorded": len(rec.spans) - n0,
           "cycle_levels": levels, "k1_names": k1[:2],
           "host_syncs": info.host_syncs,
           "span_pids": sorted({e["pid"] for e in spans})}
    print("[timers] " + json.dumps(out), flush=True)
    if not levels or not k1:
        raise AssertionError("timers: the trace lacks cycle.level or K1")
    if out["span_pids"] != [os.getpid()] or any(
            e["ph"] != "X" for e in spans):
        raise AssertionError("timers: a span left the host track")
    return out


# the sharded solve (ROADMAP item 8b): the JAX package's multi-chip oracle
# (__graft_entry__.py dryrun_multichip, MULTICHIP_r05.json) on one card,
# 8 gloo ranks sharing cuda:0
SHARD_RANKS = 8
SHARD_RTOL = 1e-5
SHARD_JAX_IT = 8  # the JAX package's sharded == replicated count
# the sharded x against the system: its true relres ||b - A x|| / ||b||
# (host matrix, f64) at most 5% above the replicated x's on the same card
# and below 1e-3. An f32 x of this system stops near 1.3e-4 however far the
# recursive residual falls (its rounding times the condition number; the
# 1e-8 solves get there by refinement passes), so 1e-5 cannot be asked of
# it; a wrong row block or x base gives O(1). And its distance to the
# replicated x (the JAX tests' sharded-solve bound).
SHARD_TRUE_RTOL = 1e-3
SHARD_TRUE_OVER_REPLICATED = 1.05
SHARD_X_RTOL = 1e-3
WINDOW_KERNEL = "dia_window_matvec_f32"


def _build_dir():
    from pathlib import Path

    d = Path(__file__).resolve().parent / "build" / "sharded"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _op_file(op, name):
    """The hierarchy with host tensors, written once for the ranks (each
    maps the file and keeps its rows)."""
    import torch

    from ngsamg_tpu_torch.smoothers.build import _to_device

    path = _build_dir() / name
    torch.save(_to_device(op, "cpu"), path)
    return str(path)


def _world_clock() -> dict:
    """Seconds from spawning the last world to its ranks' process groups
    being up (first and last rank), its functions' ends and the caller
    having every result."""
    from ngsamg_tpu_torch.parallel.world import LAST_WORLD

    t0 = LAST_WORLD["spawned"]
    ranks = LAST_WORLD["ranks"].values()
    return {
        "ready_first_s": min(c["ready"] for c in ranks) - t0,
        "ready_last_s": max(c["ready"] for c in ranks) - t0,
        "process_start_last_s": max(c["start"] for c in ranks) - t0,
        "done_last_s": max(c["done"] for c in ranks) - t0,
        "results_s": LAST_WORLD["results"] - t0,
    }


def _spawn(tasks, n, timeout=600.0):
    from ngsamg_tpu_torch.parallel.sharded_run import spawn_tasks

    return spawn_tasks(tasks, n, backend="gloo", device="cuda:0",
                       timeout=timeout)


def _replicated_steps(op, b, steps, until=0.0, tol2=1e-16):
    """The oracle's loop on one device: masked PCG steps from a zero guess
    until the residual has dropped by ``until`` (at most ``steps``)."""
    import torch

    from ngsamg_tpu_torch.solve.pcg import _pcg_init, _pcg_step

    A = op.levels[0].A
    st = _pcg_init(b)
    rn0 = float(st[4])
    t2 = torch.tensor(tol2, dtype=b.dtype, device=b.device)
    rns = []
    for _ in range(steps):
        st = _pcg_step(op, A, st, t2)
        rns.append(float(st[4]))
        if rns[-1] <= until ** 2 * rn0:
            break
    return st[0], len(rns), rns[-1] / rn0


def _halo_cases():
    """The JAX package's tests/test_parallel.py production-cycle, GS and
    sub-group problems, set up on the host with shards=8: (label, op,
    b, shard keywords, kind, steps, tol)."""
    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.utils import fem

    cases = []
    for label, prob, kw, sk, kind, steps, tol in (
        ("halo_tile_ell unstructured_poisson(100, 2, refine=1)",
         fem.unstructured_poisson(100, dim=2, refine=1),
         dict(smoother="chebyshev", mcs=60), {"replicate_below": 100},
         "steps", 16, 1e-3),
        ("halo_block_ell elasticity_3d(11) f64", fem.elasticity_3d(11),
         dict(smoother="chebyshev", dtype="float64", bs=3),
         {"replicate_below": 200}, "apply", 0, 1e-10),
        ("sharded_gs unstructured_poisson(16, 2)",
         fem.unstructured_poisson(16, dim=2), dict(smoother="gs", mcs=40),
         {"replicate_below": 50}, "steps", 12, 1e-4),
        ("sub_groups poisson_3d(20) f64", fem.poisson_3d(20),
         dict(dtype="float64"),
         {"replicate_below": 4096, "min_local_rows": 128}, "apply", 0,
         1e-10),
    ):
        o = _options(kw.get("smoother"), shards=SHARD_RANKS,
                     dtype=kw.get("dtype", "float32"))
        if "mcs" in kw:
            o.levels.max_coarse_size = kw["mcs"]
        extra = ({"energy": "elasticity", "block_size": 3}
                 if kw.get("bs") else {})
        pc = AMGPreconditioner(prob.A, coords=prob.coords, options=o,
                               device="cpu", **extra).setup()
        bs = kw.get("bs", 1)
        b = np.zeros((pc.A_dev.nrows_pad, bs))
        b.reshape(-1)[: prob.A.shape[0]] = np.random.default_rng(
            len(cases)).standard_normal(prob.A.shape[0])
        cases.append((label, pc.op, b, sk, kind, steps, tol))
    return cases


def _sharded_staging(p, pc):
    """Phase 22's host levels staged again on the card with shards=8, as
    the JAX package's multi-chip oracle stages them: every level padded to
    a multiple of 8 * 8 rows, plain tile-ELL. Returns (preconditioner,
    staging seconds)."""
    import torch

    from ngsamg_tpu_torch import AMGPreconditioner

    pc8 = AMGPreconditioner(p.A, coords=p.coords,
                            options=_dist_opts(shards=DIST_SHARDS),
                            device="cuda")
    # the same host hierarchy: staging reads the levels, never writes them
    pc8.setup_levels_, pc8.log_ = pc.setup_levels_, pc.log_
    t0 = time.perf_counter()
    pc8._compile_device()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pc8._is_setup = True
    formats = [type(lev.A).__name__ for lev in pc8.op.levels]
    pads = [lev.A.nrows_pad for lev in pc8.op.levels
            if hasattr(lev.A, "nrows_pad")]
    if formats != SHARDED_FORMATS or any(n % (8 * DIST_SHARDS)
                                         for n in pads):
        raise AssertionError(f"sharded: staged as {formats}, padded rows "
                             f"{pads}")
    return pc8, secs


def phase_sharded(p, pc, halo):
    """[sharded] and [sharded-halo]: one world of 8 gloo ranks on cuda:0.

    [sharded] places phase 22's hierarchy (7 levels; its host levels
    staged again with shards=8, ``_sharded_staging``) with ``shards_hint
    = log.shards_per_level``: the residual
    must contract over two PCG steps, the sharded PCG to 1e-5 must take
    the replicated count on this card (the JAX package's: 8) with rel r^2
    < 1e-10, and K2 on the rank's window must launch on every rank and equal
    its plain version on every rank's block of level 0; its time on rank
    0's block beside its bytes, bound and cuSPARSE on the same rows.
    [sharded-halo] runs ``halo`` (``_halo_cases``) in the same world, each
    against the replicated result on this card."""
    import torch

    from ngsamg_tpu_torch.smoothers.build import _to_device
    from ngsamg_tpu_torch.solve.cycle import amg_apply

    t0 = time.perf_counter()
    pc, staging_s = _sharded_staging(p, pc)
    log = pc.log_
    hint = list(log.shards_per_level)
    sk = {"shards_hint": hint}
    path = _op_file(pc.op, "dist_setup_op.pt")
    b = pc._to_dev(p.b).cpu().numpy()
    tasks = [
        dict(kind="pcg", op=path, b=b, steps=2, tol2=1e-16, shard=sk),
        dict(kind="pcg", op=path, b=b, steps=60, until=SHARD_RTOL,
             tol2=1e-16, shard=sk),
        dict(kind="pcg", op=path, b=b, tol=SHARD_RTOL, maxiter=60, warm=1,
             shard=sk),
        dict(kind="window_k2", op=path, shard=sk, seed=500),
    ]
    for _label, op, hb, hk, kind, steps, _tol in halo:
        if kind == "apply":
            tasks.append(dict(kind="apply", op=op, b=hb, shard=hk))
        else:
            tasks.append(dict(kind="pcg", op=op, b=hb, steps=steps,
                              tol2=1e-30, shard=hk))
    t1 = time.perf_counter()
    res = _spawn(tasks, SHARD_RANKS)
    t2 = time.perf_counter()
    two, orc, warm, win = res[:4]
    bt = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    x_rep, it_rep, rr_rep = _replicated_steps(pc.op, bt, 60, SHARD_RTOL)
    # the sharded solution in the user's space, held to the system it
    # solves (b - A x with the host matrix, in f64) and to the replicated
    # solution on this card
    x_sh = pc._from_dev(torch.as_tensor(orc["x"], device="cuda"))
    x_rp = pc._from_dev(x_rep)
    bn = float(np.linalg.norm(p.b))
    true_sh = float(np.linalg.norm(p.b - p.A @ x_sh)) / bn
    true_rp = float(np.linalg.norm(p.b - p.A @ x_rp)) / bn
    x_diff = float(np.linalg.norm(x_sh - x_rp) / np.linalg.norm(x_rp))
    per_it = max(orc["iterations"], 1)
    launches = [r.get(WINDOW_KERNEL, 0) for r in orc["launches_per_rank"]]
    nbytes, flops = win["bytes"], win["flops"]
    bound_ms, bound_by = _bound_ms(nbytes, flops, torch.float32)
    out = {
        "levels": len(orc["counts"]),
        "operator_complexity": pc.operator_complexity,
        "placement": hint, "level_shard_counts": list(orc["counts"]),
        "level_formats_rank0": [lev["A"] for lev in orc["levels"]],
        "two_steps_rn": two["rn"],
        "iterations_sharded": orc["iterations"],
        "iterations_replicated": it_rep,
        "iterations_jax": SHARD_JAX_IT,
        "rel_r2_sharded": orc["rn"][-1] / orc["rn0"],
        "rel_r2_replicated": rr_rep,
        "relres_true_sharded": true_sh,
        "relres_true_replicated": true_rp,
        "x_rel_diff_vs_replicated": x_diff,
        "staging_s": staging_s,
        "collectives_per_iteration_rank0": {
            k: v / per_it for k, v in orc["collectives"].items()},
        "warm_solve_s": warm["seconds"],
        "warm_solve_iterations": warm["iterations"],
        "window_k2": {k: win[k] for k in (
            "terms", "window", "device_ms", "cold_ms", "call_ms",
            "plain_ms", "library_ms")},
        "window_k2_bytes": nbytes, "window_k2_flops": flops,
        "window_k2_bound_ms": bound_ms, "window_k2_bound_by": bound_by,
        "window_k2_checks": win["checks"],
        "window_k2_launches_per_rank": launches,
        "world_s": t2 - t1, "host_files_s": t1 - t0,
        "task_wall_s_rank0": [r.get("wall_s") for r in res],
        "world_clock": _world_clock(),
    }
    print("[sharded] " + json.dumps(out), flush=True)
    if out["levels"] != len(DIST_LEVELS) or round(
            out["operator_complexity"], 4) != DIST_OC:
        raise AssertionError("sharded: not the oracle's hierarchy")
    if hint != DIST_SHARDS_PER_LEVEL or any(
            c > max(h, 1) for c, h in zip(orc["counts"], hint)) or not any(
            c < SHARD_RANKS for c in orc["counts"][1:]):
        raise AssertionError(f"sharded: placement {orc['counts']} against "
                             f"the hint {hint}")
    if not two["rn"][1] < two["rn"][0]:
        raise AssertionError(f"sharded: residual {two['rn']} not contracting")
    if (orc["iterations"] != it_rep or orc["iterations"] >= 60
            or out["rel_r2_sharded"] >= 1e-10):
        raise AssertionError(f"sharded: {orc['iterations']} iterations "
                             f"against the replicated {it_rep}")
    if not (np.isfinite(x_sh).all() and true_sh < SHARD_TRUE_RTOL
            and true_sh <= SHARD_TRUE_OVER_REPLICATED * true_rp
            and x_diff < SHARD_X_RTOL):
        raise AssertionError(
            f"sharded: true relres {true_sh} (bound {SHARD_TRUE_RTOL}, and "
            f"{SHARD_TRUE_OVER_REPLICATED} x the replicated {true_rp}), x "
            f"against the replicated {x_diff} (bound {SHARD_X_RTOL})")
    if min(launches) <= 0 or len(launches) != SHARD_RANKS:
        raise AssertionError(f"sharded: {WINDOW_KERNEL} launches {launches}")
    for c in win["checks"]:
        if c["rel_err"] > F32_TOL or not c["same_bits"]:
            raise AssertionError(f"sharded: windowed K2 on rank {c['rank']}:"
                                 f" {c}")
    src, replaces = KERNELS["dia_matvec_f32"]
    row = {
        "name": WINDOW_KERNEL, "path": "sharded", "route": "cuda",
        "source": src, "replaces": replaces,
        "launches": int(sum(launches)), "launches_per_rank": launches,
        "max_abs_err": max(c["max_abs_err"] for c in win["checks"]),
        "ms": win["device_ms"], "device_ms": win["device_ms"],
        "cold_ms": win["cold_ms"], "call_ms": win["call_ms"],
        "plain_ms": win["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": win["library_ms"],
        "rows": win["checks"][0]["rows"], "terms": win["terms"],
    }
    # [sharded-halo]
    hout = {}
    for (label, op, hb, _hk, kind, _steps, tol), r in zip(halo, res[4:]):
        opc = _to_device(op, "cuda")
        dt = opc.levels[0].smoother.Dinv.dtype
        bt = torch.as_tensor(hb, dtype=dt, device="cuda")
        if kind == "apply":
            ref = amg_apply(opc, bt).cpu().numpy()
            err = float(np.linalg.norm(r["y"] - ref) / np.linalg.norm(ref))
        else:
            xr, _k, _rr = _replicated_steps(opc, bt, _steps, tol2=1e-30)
            xr = xr.cpu().numpy()
            err = float(np.abs(r["x"] - xr).max() / np.abs(xr).max())
        hout[label] = {
            "level_shard_counts": list(r["counts"]),
            "level_formats_rank0": [lev["A"] for lev in r["levels"]],
            "smoothers_rank0": [lev["smoother"] for lev in r["levels"]],
            "comm_per_apply": [lev["comm_per_apply"] for lev in r["levels"]],
            "collectives_rank0": r.get("collectives"),
            "err_vs_replicated": err, "tol": tol,
        }
    print("[sharded-halo] " + json.dumps(hout), flush=True)
    want = {"halo_tile_ell": "HaloTileELL", "halo_block_ell": "HaloBlockELL",
            "sharded_gs": "BlockELL"}
    for label, h in hout.items():
        kind = label.split()[0]
        if not h["err_vs_replicated"] < h["tol"]:
            raise AssertionError(f"sharded-halo {label}: {h}")
        if kind in want and want[kind] not in h["level_formats_rank0"]:
            raise AssertionError(f"sharded-halo {label}: formats "
                                 f"{h['level_formats_rank0']}")
        if kind == "sharded_gs" and ("ShardedGS" not in h["smoothers_rank0"]
                                     or not h["collectives_rank0"]
                                     ["gs_rounds"]):
            raise AssertionError(f"sharded-halo {label}: no sharded GS")
        if kind == "sub_groups" and not any(
                1 < c < SHARD_RANKS for c in h["level_shard_counts"]):
            raise AssertionError(f"sharded-halo {label}: no sub-group level")
    print(f"[sharded] {time.perf_counter() - t0:.1f} s", flush=True)
    return out, row


def phase_collective_transport():
    """dist_setup_levels and dist_stokes_levels over CollectiveTransport:
    4 gloo ranks whose words live on cuda:0, bitwise the LocalTransport
    hierarchy."""
    from ngsamg_tpu_torch.apps.h1 import H1Energy
    from ngsamg_tpu_torch.parallel.dist_setup import dist_setup_levels
    from ngsamg_tpu_torch.parallel.dist_stokes import dist_stokes_levels
    from ngsamg_tpu_torch.parallel.mp_runtime import (
        mp_dist_setup_levels, mp_dist_stokes_levels)
    from ngsamg_tpu_torch.utils import fem
    from ngsamg_tpu_torch.utils.stokes_fem import stokes_tri

    t0 = time.perf_counter()
    coll = dict(transport="collective", backend="gloo", device="cuda:0")
    out = {}
    # the JAX package's tests' sizes (tests/test_dist_setup.py,
    # tests/test_dist_stokes.py): a call costs tens of ms through gloo on
    # CUDA tensors, and [mp-setup]'s poisson_3d(41) takes 555 of them
    p = fem.unstructured_poisson(14, dim=2)
    ref, _ = dist_setup_levels(p.A, H1Energy(bs=1), _dist_opts(mcs=40),
                               MP_RANKS)
    t1 = time.perf_counter()
    levels, log = mp_dist_setup_levels(p.A, H1Energy(bs=1),
                                       _dist_opts(mcs=40), MP_RANKS, **coll)
    t2 = time.perf_counter()
    _levels_bitwise("collective-transport unstructured_poisson(14, 2)", ref,
                    levels)
    if len(levels) < 2:
        raise AssertionError("collective-transport: one level only")
    out["unstructured_poisson(14, 2)"] = {
        "level_sizes": list(log.nvs), "collective_s": t2 - t1,
        "world_clock": _world_clock(),
        "ranks": [{k: st[k] for k in ("transport_calls", "moved_bytes")}
                  for st in log.mp_rank_stats]}
    s, _normals = stokes_tri(8, dim=2, alpha=10.0)
    spc = _stokes_amg(s, 60, device="cpu", geometric=False)
    opts = spc.options
    sref = dist_stokes_levels(spc.A_host, spc.mesh0, 1, opts, MP_RANKS)
    t3 = time.perf_counter()
    slev, slog = mp_dist_stokes_levels(spc.A_host, spc.mesh0, 1, opts,
                                       MP_RANKS, **coll)
    t4 = time.perf_counter()
    if len(sref) != len(slev):
        raise AssertionError("collective-transport: Stokes level counts")
    for i, (a, c) in enumerate(zip(sref, slev)):
        for ma, mc in ((a.A, c.A), (a.P, c.P), (a.C, c.C)):
            if (ma is None) != (mc is None) or (
                    ma is not None and abs(ma - mc).max() != 0.0):
                raise AssertionError(f"collective-transport: Stokes level "
                                     f"{i} differs")
        if not np.array_equal(a.mesh.edge_data["flow"],
                              c.mesh.edge_data["flow"]):
            raise AssertionError(f"collective-transport: flows level {i}")
    out["stokes_tri(8, 2)"] = {
        "levels": len(slev), "collective_s": t4 - t3,
        "world_clock": _world_clock(),
        "ranks": [{k: st[k] for k in ("transport_calls", "moved_bytes")}
                  for st in slog.mp_rank_stats]}
    out["s"] = time.perf_counter() - t0
    print("[collective-transport] " + json.dumps(out), flush=True)
    if not all(st["transport_calls"] > 0 for st in log.mp_rank_stats):
        raise AssertionError("collective-transport: no exchange ran")
    return out


# [dist-stokes]: stokes_tri(8, dim=3), 6,470 facet DoF. Its distributed
# setup takes 44-47 s on a host CPU, n = 10 several times that
# (scripts/dist_stokes_fill.py), more than the script's time allows
DIST_STOKES_N = 8


def phase_dist_stokes():
    """The distributed Stokes setup on the card against the serial one on
    the same card. The bench leg cannot run it: with the default
    (curl-smoothed) prolongation the distributed setup's P fills in on 3D
    meshes (the JAX package's too: at stokes_tri(8, dim=3) its level-1 P
    is 99% dense), stokes_tri(20, dim=3) through dist_setup=8 met the
    card host's 96 GiB, and the setup's host time grows about as n^8
    (scripts/dist_stokes_fill.py; ROADMAP section 3). So: the largest
    size within the script's time, stokes_tri(DIST_STOKES_N, dim=3), through
    StokesAMG(dist_setup=8) against its serial setup (the same level
    sizes, at most 10 iterations more, the JAX tests' band; true relres
    <= 1e-8), and stokes_tri_hdiv(14) through StokesHDivAMG(dist_setup=3)
    against its serial setup (the same levels, P within 1e-9)."""
    from ngsamg_tpu_torch import AMGOptions
    from ngsamg_tpu_torch.precond.stokes import StokesHDivAMG
    from ngsamg_tpu_torch.utils import stokes_fem as sf

    t0 = time.perf_counter()
    prob, _normals = sf.stokes_tri(DIST_STOKES_N, dim=3, alpha=10.0)
    runs = {}
    for dist in (0, DIST_SHARDS):
        pc = _stokes_amg(prob, 80, geometric=False, dist_setup=dist).setup()
        res = _stokes_solves(pc, prob, 150, warm=1, first=False)
        runs[dist] = {"level_sizes": [int(c.A.shape[0])
                                      for c in pc.setup_levels_],
                      "setup_host_s": pc.setup_time_host,
                      "iterations": res["iterations"],
                      "relres_true": res["relres_true"],
                      "warm_solve_s": res["warm_solve_s"]}
    label = f"stokes_tri({DIST_STOKES_N}, 3)"
    out = {label: {"dofs": int(prob.n), "serial": runs[0],
                   "dist": runs[DIST_SHARDS]}}
    hd = {}
    ph, counts, V = sf.stokes_tri_hdiv(14)
    for dist in (0, 3):
        o = AMGOptions(dist_setup=dist)
        o.levels.max_coarse_size = 120
        hpc = StokesHDivAMG(
            ph.A, cell_pos=ph.cell_pos, cell_vol=ph.cell_vol,
            facet_cells=ph.facet_cells, facet_flow=ph.facet_flow,
            facet_dof_counts=counts, preserved=V, options=o,
            device="cuda").setup()
        x, info = hpc.solve(ph.b, tol=1e-8, maxiter=500)
        hd[dist] = (hpc.setup_levels_, int(info.iterations),
                    _true_relres(ph.A, ph.b, x), bool(info.converged))
    (sl, si, _sr, _sc), (dl, di, dr, dc) = hd[0], hd[3]
    dP = max((float(abs(a.P - b.P).max()) for a, b in zip(sl, dl)
              if a.P is not None), default=0.0)
    out["stokes_tri_hdiv(14)"] = {
        "levels": len(dl), "serial_levels": len(sl),
        "iterations": di, "serial_iterations": si, "relres_true": dr,
        "max_P_diff": dP}
    out["s"] = time.perf_counter() - t0
    print("[dist-stokes] " + json.dumps(out), flush=True)
    ser, dis = runs[0], runs[DIST_SHARDS]
    if dis["level_sizes"] != ser["level_sizes"] or dis["iterations"] > \
            ser["iterations"] + 10:
        raise AssertionError(f"dist-stokes: {out[label]}")
    if len(dl) != len(sl) or dP > 1e-9 or not dc or dr > 1e-8 \
            or di > si + 10:
        raise AssertionError(f"dist-stokes: HDiv "
                             f"{out['stokes_tri_hdiv(14)']}")
    return out


def phase_mp_stokes():
    """The two Stokes MP entry points on 2 rank processes (pipes, numpy
    ranks): equal to the single controller."""
    from ngsamg_tpu_torch import AMGOptions
    from ngsamg_tpu_torch.parallel.dist_stokes import (
        dist_stokes_hdiv_levels, dist_stokes_levels)
    from ngsamg_tpu_torch.parallel.mp_runtime import (
        mp_dist_stokes_hdiv_levels, mp_dist_stokes_levels)
    from ngsamg_tpu_torch.precond.stokes import StokesHDivAMG
    from ngsamg_tpu_torch.utils import stokes_fem as sf

    t0 = time.perf_counter()
    s, _normals = sf.stokes_tri(10, dim=2, alpha=10.0)
    spc = _stokes_amg(s, 60, device="cpu", geometric=False)
    ref = dist_stokes_levels(spc.A_host, spc.mesh0, 1, spc.options, 2)
    got, log = mp_dist_stokes_levels(spc.A_host, spc.mesh0, 1, spc.options,
                                     2)
    ph, counts, V = sf.stokes_tri_hdiv(8, alpha=10.0)
    o = AMGOptions()
    o.levels.max_coarse_size = 120
    hpc = StokesHDivAMG(
        ph.A, cell_pos=ph.cell_pos, cell_vol=ph.cell_vol,
        facet_cells=ph.facet_cells, facet_flow=ph.facet_flow,
        facet_dof_counts=counts, preserved=V, options=o, device="cpu")
    href = dist_stokes_hdiv_levels(hpc.A_host, hpc.mesh0, hpc.dofs0,
                                   hpc.pres0, o, 2)
    hgot, hlog = mp_dist_stokes_hdiv_levels(hpc.A_host, hpc.mesh0,
                                            hpc.dofs0, hpc.pres0, o, 2)
    for label, a_lv, b_lv in (("stokes", ref, got), ("hdiv", href, hgot)):
        if len(a_lv) != len(b_lv) or len(a_lv) < 2:
            raise AssertionError(f"mp-stokes {label}: level counts")
        for i, (a, b) in enumerate(zip(a_lv, b_lv)):
            for ma, mb in ((a.A, b.A), (a.P, b.P),
                           (getattr(a, "C", None), getattr(b, "C", None))):
                if (ma is None) != (mb is None) or (
                        ma is not None and abs(ma - mb).max() != 0.0):
                    raise AssertionError(f"mp-stokes {label}: level {i}")
    out = {"stokes_tri(10, 2)": {"levels": len(got),
                                  "peak_shard_bytes": log.peak_shard_bytes},
           "stokes_tri_hdiv(8)": {"levels": len(hgot),
                                   "peak_shard_bytes": hlog.peak_shard_bytes},
           "s": time.perf_counter() - t0}
    print("[mp-stokes] " + json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch

    import ngsamg_tpu_torch  # noqa: F401  (fails outside the repository)

    phase_device()
    native_build = phase_build()
    phase_native(native_build)
    p, pc, main_out = phase_main_path()
    rows = phase_kernels(p, pc, main_out["launches"])
    _warm, warm_launches = phase_reference(p, pc)
    for row in rows:
        row["launches_warm_solve"] = int(warm_launches[row["name"]])
    phase_selftest(pc)
    del pc
    bf16_rows, _solves = phase_bf16(p, rows)
    api_pc, api_launches = phase_api(p)
    for row in rows:
        row["launches_api"] = int(api_launches[row["name"]])
    phase_timers(api_pc, p)
    del api_pc, p
    _up, upc, _uout = phase_unstructured()
    phase_tile_ell(upc)
    phase_tile_ell_kernel(upc, "unstructured")
    del _up, upc
    unstruct_errs = phase_unstructured_reference()
    phase_mis()
    _ep, epc, _eout = phase_elasticity()
    phase_block_ell(epc)
    del _ep, epc
    phase_elasticity_reference()
    phase_frontend_reference()
    from ngsamg_tpu_torch.utils import fem

    gp = fem.poisson_3d(GS_N)
    phase_gs(gp)
    cycles = phase_cycles(gp)
    dist_pc, _dist, dist_row = phase_dist_setup(gp)
    _sharded, window_row = phase_sharded(gp, dist_pc, _halo_cases())
    del gp, dist_pc
    q_elast, _delast = phase_dist_elasticity()
    phase_mp_setup(q_elast)
    del q_elast
    phase_mp_stokes()
    phase_collective_transport()
    phase_gs_reference()
    phase_stokes()
    phase_dist_stokes()
    _mac, stokes_row = phase_stokes_mac()
    phase_stokes_reference()
    phase_api_reference()
    for row in rows:  # one warm solve of poisson_3d(101), W and BS cycles
        for label in ("W", "BS"):
            row[f"launches_{label}"] = int(
                cycles[label]["kernel_launches_warm"][row["name"]])
    for row in rows:  # fold in the checks at the small unstructured shapes
        err = unstruct_errs.get(row["name"])
        if err is not None:
            row["max_abs_err"] = max(row["max_abs_err"], err)
    print(_nvidia_smi())
    print(json.dumps({"kernels": rows + bf16_rows
                      + [stokes_row, dist_row, window_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
