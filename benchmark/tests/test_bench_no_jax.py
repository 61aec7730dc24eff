"""Nothing the harness loads for its cells is JAX or the JAX package.

In a fresh interpreter (the test process may hold JAX through other
tests), run the harness on the CPU through both tiny cells, traced, so that
every module a run imports is loaded, with every reader; then no loaded
module's top-level name may be ``jax``, ``jaxlib``, ``flax`` or
``ngsamg_tpu``. The plain reference loads nothing of the program.
"""

import json
import subprocess
import sys
import textwrap

from benchmark.tests.conftest import ROOT, make_tree

SCRIPT = textwrap.dedent(
    """
    import json, sys
    from pathlib import Path
    sys.path.insert(0, {root!r})
    import benchmark.reference.residual
    ref_only = sorted(m for m in sys.modules
                      if m.split(".")[0] == "ngsamg_tpu_torch")
    from benchmark import run
    import benchmark.problems as problems
    for g in ("lattice_poisson", "unstructured_elasticity"):
        problems.generator(g)
    for cell in ("lattice_tiny.solve", "elasticity_tiny.solve"):
        res = run.run_cell(Path({tree!r}), cell, 3, 0.2, True, device="cpu")
        assert res["correct"], res
    tops = sorted({{m.split(".")[0] for m in sys.modules}})
    print(json.dumps({{"ref_only": ref_only, "tops": tops,
                      "forbidden": run.forbidden_modules()}}))
    """
)


def test_harness_loads_no_jax(tmp_path):
    tree = make_tree(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT), tree=str(tree))],
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["ref_only"] == []
    assert seen["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "ngsamg_tpu"} & set(seen["tops"])
    assert "ngsamg_tpu_torch" in seen["tops"]
