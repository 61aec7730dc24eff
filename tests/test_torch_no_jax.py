"""ngsamg_tpu_torch must run where JAX does not exist.

In a fresh interpreter (this test process has already imported
ngsamg_tpu and JAX via tests/conftest.py), import the package and every
module in it, run seven small solves on the CPU — a lattice problem
(structured setup), an unstructured one (generic level loop, tile-ELL,
cluster correction, host refinement), a lattice problem on the default
options (multicolor GS), a 3D elasticity one (block energies,
block-ELL, the mixed-precision PCG), a Stokes one (dual-mesh facet
AMG with geometric loops and Hiptmair smoothing), an unstructured one
through the host-distributed setup (``dist_setup=4``) and a lattice one
through ``api.h1_scal``, a Stokes one through the distributed Stokes
setup (``dist_setup=2``) and a sharded solve in a spawned world of two
gloo ranks, whose ranks report their own modules — and check that neither
`jax` nor `ngsamg_tpu` (its native extension included) was ever imported.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import importlib, pkgutil
    import ngsamg_tpu_torch
    from ngsamg_tpu_torch.utils import fem

    mods = sorted(
        m.name for m in pkgutil.walk_packages(
            ngsamg_tpu_torch.__path__, "ngsamg_tpu_torch."
        )
    )
    for name in mods:
        importlib.import_module(name)
    for name in ("apps.elasticity", "sparse.bell", "sparse.host",
                 "coarsen.pairwise", "transfer.prolongation",
                 "transfer.galerkin", "solve.pcg", "precond.convert",
                 "utils.trace_solve", "smoothers.coloring",
                 "smoothers.block", "apps.elmat", "ops.batched_la",
                 "apps.stokes", "apps.stokes_hdiv", "utils.stokes_fem",
                 "smoothers.hiptmair", "precond.stokes",
                 "parallel.transport", "parallel.dist_setup",
                 "parallel.dist_elast", "parallel.mp_runtime",
                 "utils.timers", "api", "parallel.world",
                 "parallel.shard", "parallel.halo",
                 "parallel.sharded_run", "parallel.dist_stokes"):
        assert "ngsamg_tpu_torch." + name in mods, name

    p = fem.poisson_3d(34)  # 35,937 DoF: the uniform-stencil branches
    opts = ngsamg_tpu_torch.AMGOptions(
        smoother=ngsamg_tpu_torch.SmootherOptions(
            type=ngsamg_tpu_torch.SmootherType.CHEBYSHEV
        )
    )
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cpu"
    ).setup()
    x, info = pc.solve(p.b, tol=1e-8)
    rel = np.linalg.norm(p.b - p.A @ x) / np.linalg.norm(p.b)
    assert info.converged and rel <= 1e-8, (info, rel)
    q = fem.unstructured_poisson(16, dim=3, refine=1)  # 32,720 DoF
    pcu = ngsamg_tpu_torch.AMGPreconditioner(
        q.A, coords=q.coords, options=opts, device="cpu"
    ).setup()
    assert pcu.op.cluster_corr is not None
    xu, infou = pcu.solve(q.b, tol=1e-8)
    relu = np.linalg.norm(q.b - q.A @ xu) / np.linalg.norm(q.b)
    assert infou.converged and relu <= 1e-8, (infou, relu)
    g = fem.poisson_3d(20)  # the JAX package's defaults: multicolor GS, V
    pcg_ = ngsamg_tpu_torch.AMGPreconditioner(
        g.A, coords=g.coords, options=ngsamg_tpu_torch.AMGOptions(),
        device="cpu",
    ).setup()
    assert type(pcg_.op.levels[0].smoother).__name__ == "GSSmoother"
    xg, infog = pcg_.solve(g.b, tol=1e-8)
    relg = np.linalg.norm(g.b - g.A @ xg) / np.linalg.norm(g.b)
    assert infog.converged and relg <= 1e-8, (infog, relg)
    e = fem.elasticity_3d(8)  # 19,440 DoF: a block-ELL finest level
    pce = ngsamg_tpu_torch.AMGPreconditioner(
        e.A, energy="elasticity", block_size=3, coords=e.coords,
        options=opts, device="cpu",
    ).setup()
    assert type(pce.A_dev).__name__ == "BlockELL"
    xe, infoe = pce.solve(e.b, tol=1e-8, mixed=True)
    rele = np.linalg.norm(e.b - e.A @ xe) / np.linalg.norm(e.b)
    assert infoe.converged and rele <= 1e-8, (infoe, rele)
    from ngsamg_tpu_torch.precond.stokes import StokesAMG
    from ngsamg_tpu_torch.utils.stokes_fem import stokes_tri

    s, _normals = stokes_tri(10, dim=2)  # 280 facet DoF
    sopts = ngsamg_tpu_torch.AMGOptions()
    sopts.levels.max_coarse_size = 40
    pcs = StokesAMG(
        s.A, cell_pos=s.cell_pos, cell_vol=s.cell_vol,
        facet_cells=s.facet_cells, facet_flow=s.facet_flow,
        facet_verts=s.facet_verts, vert_pos=s.vert_pos,
        bnd_facet_verts=s.bnd_facet_verts, options=sopts, device="cpu",
    ).setup()
    assert type(pcs.op.levels[0].smoother).__name__ == "HiptmairSmoother"
    xs, infos = pcs.solve(s.b, tol=1e-8)
    rels = np.linalg.norm(s.b - s.A @ xs) / np.linalg.norm(s.b)
    assert infos.converged and rels <= 1e-8, (infos, rels)
    d = fem.unstructured_poisson(16, dim=2)  # the distributed setup
    dopts = ngsamg_tpu_torch.AMGOptions(
        dist_setup=4, smoother=opts.smoother
    )
    pcd = ngsamg_tpu_torch.AMGPreconditioner(
        d.A, coords=d.coords, options=dopts, device="cpu"
    ).setup()
    assert pcd.log_.shards_per_level[0] == 4
    xd, infod = pcd.solve(d.b, tol=1e-8)
    reld = np.linalg.norm(d.b - d.A @ xd) / np.linalg.norm(d.b)
    assert infod.converged and reld <= 1e-8, (infod, reld)
    from ngsamg_tpu_torch import api

    pca = api.h1_scal(g.A, coords=g.coords, ngs_amg_sm_type="chebyshev",
                      device="cpu")
    xa, infoa = pca.solve(g.b, tol=1e-8)
    assert infoa.converged and pca.GetNLevels() == pca.num_levels
    sd, _n = stokes_tri(8, dim=2)  # the distributed Stokes setup
    sdo = ngsamg_tpu_torch.AMGOptions(dist_setup=2)
    sdo.levels.max_coarse_size = 40
    pcsd = StokesAMG(
        sd.A, cell_pos=sd.cell_pos, cell_vol=sd.cell_vol,
        facet_cells=sd.facet_cells, facet_flow=sd.facet_flow,
        options=sdo, device="cpu",
    ).setup()
    xsd, infosd = pcsd.solve(sd.b, tol=1e-8)
    assert infosd.converged and pcsd.num_levels >= 2
    # the sharded solve in a spawned world of two gloo ranks
    from ngsamg_tpu_torch.parallel.sharded_run import spawn_tasks
    from ngsamg_tpu_torch.sparse.formats import block_vec

    h = fem.poisson_3d(12)
    pch = ngsamg_tpu_torch.AMGPreconditioner(
        h.A, coords=h.coords, device="cpu",
        options=ngsamg_tpu_torch.AMGOptions(shards=2, smoother=opts.smoother),
    ).setup()
    bh = block_vec(h.b, 1, pch.A_dev.nrows_pad, torch.float32).numpy()
    ranks, sol = spawn_tasks(
        [{"kind": "import_check"},
         {"kind": "pcg", "op": pch.op, "b": bh, "tol": 1e-5,
          "shard": {"replicate_below": 100}}],
        2, backend="gloo", device="cpu", timeout=120,
    )
    assert not ranks["jax"] and not ranks["ngsamg_tpu"], ranks
    assert sol["counts"][0] == 2 and sol["relres"] < 1e-5, sol["counts"]
    bad = sorted(
        m for m in sys.modules
        if m in ("jax", "jaxlib", "ngsamg_tpu")
        or m.startswith(("jax.", "jaxlib.", "ngsamg_tpu."))
    )
    assert not bad, bad
    print("OK", info.iterations, infou.iterations, infog.iterations,
          infoe.iterations, infos.iterations, infod.iterations,
          infoa.iterations, infosd.iterations, sol["iterations"])
    """
)


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().startswith("OK")


def test_port_sources_never_name_jax():
    """No module of the port imports the JAX package or JAX itself."""
    pkg = os.path.join(ROOT, "ngsamg_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for line in fh:
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        assert "jax" not in s, (f, s)
                        assert "ngsamg_tpu." not in s and not s.startswith(
                            ("import ngsamg_tpu ", "from ngsamg_tpu ")
                        ), (f, s)
