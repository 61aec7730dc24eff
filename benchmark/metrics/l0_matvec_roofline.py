"""Share of the roofline of one float32 matvec of the finest staged level:
the least time by ``benchmark/roofline.py``'s count of the problem's work,
over the median time of ``formats.matvec(pc.A_dev, x)`` after an L2-sweeping
write (``benchmark/timing.py``). The count is the problem's, never the
format's, so whatever implements the matvec is held to the same work."""

import sys

import numpy as np
import torch

from benchmark import roofline, timing


def read(run):
    if run.device.type != "cuda":
        return None
    from ngsamg_tpu_torch.sparse import formats

    pc = run.pc
    A_dev = pc.A_dev
    bs = int(pc.setup_levels_[0].row_bs)
    g = np.random.default_rng(0)
    x = formats.block_vec(g.standard_normal(A_dev.nrows * bs), bs,
                          A_dev.nrows_pad, pc.dtype, pc.device)
    ms = timing.cold_ms(lambda: formats.matvec(A_dev, x))
    ops, nbytes = roofline.matvec_work(run.A, run.block_size)
    t, by = roofline.bound_s(ops, nbytes)
    print(f"[bench] l0 matvec {type(A_dev).__name__}: {ms * 1e3:.2f} us, "
          f"{ops} ops, {nbytes} B, bound {t * 1e6:.2f} us by {by}",
          file=sys.stderr, flush=True)
    del x
    torch.cuda.synchronize()
    return 100.0 * t / (ms * 1e-3)
