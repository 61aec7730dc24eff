"""The one traffic generator: a mix file's parameters drive the solves.

A mix (``benchmark/traffic/<name>.json``) holds:

- ``loop``: ``"closed"``, the one loop there is: each caller sends its next
  right-hand side when its previous solve has returned;
- ``clients``: callers in the loop (1: one process, one thread);
- ``rhs_memory``: where the caller's right-hand side lies on the host,
  ``"pinned"`` (page-locked, as a caller that stages its vectors for a card
  keeps them) or ``"pageable"`` (a plain array);
- ``return_device``: passed to ``solve``: the answer stays on the card where
  the program's path allows it;
- ``warmup_solves``: solves in set-up, before the window;
- ``checked_solves``: the window's answers kept for the check, a uniform
  sample drawn from the seed (reservoir sampling), so that the memory they
  hold does not grow with the number of solves;
- ``traced_solves``: solves under the profiler after the window, with
  ``--trace 1``; their answers are all checked.

Every solve of a run gets a right-hand side of its own: solve ``k`` takes
the standard-normal vector drawn from ``(seed, k)``, so no right-hand side
comes back within a run and the check can draw each one again.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

KEYS = {"loop", "clients", "rhs_memory", "return_device", "warmup_solves",
        "checked_solves", "traced_solves"}
MEMORY = ("pinned", "pageable")


def check_mix(mix: dict) -> None:
    if set(mix) != KEYS:
        raise ValueError(f"a mix has the keys {sorted(KEYS)}, "
                         f"not {sorted(mix)}")
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise ValueError("only a closed loop with one client is driven")
    if mix["rhs_memory"] not in MEMORY:
        raise ValueError(f"rhs_memory is one of {MEMORY}")
    for k in ("checked_solves", "traced_solves"):
        if int(mix[k]) < 1:
            raise ValueError(f"{k} must be at least 1")


def stream_seed(seed: int, k: int) -> int:
    """The generator seed of solve ``k``'s right-hand side."""
    ss = np.random.SeedSequence([int(seed) % 2**64, int(k)])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


class Rhs:
    """Right-hand sides of length ``n`` from ``seed``: ``draw(k)`` makes
    solve ``k``'s standard-normal float64 vector on ``device`` and copies it
    into one host buffer, which it returns as the caller's array. Both
    buffers are made once, so a draw allocates nothing; ``device_bytes`` is
    what the device buffer holds, the harness's own share of the device's
    memory."""

    def __init__(self, n: int, seed: int, device, memory: str):
        self.n, self.seed = int(n), int(seed)
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_allocated(self.device) if cuda else 0
        self._dev = torch.empty(self.n, dtype=torch.float64,
                                device=self.device)
        self.device_bytes = (torch.cuda.memory_allocated(self.device)
                             - before if cuda else 0)
        self._gen = torch.Generator(device=self.device)
        self._host = torch.empty(self.n, dtype=torch.float64,
                                 pin_memory=cuda and memory == "pinned")
        self._array = self._host.numpy()

    def draw(self, k: int) -> np.ndarray:
        self._gen.manual_seed(stream_seed(self.seed, k))
        torch.randn(self.n, generator=self._gen, dtype=torch.float64,
                    device=self.device, out=self._dev)
        self._host.copy_(self._dev)
        return self._array


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def to_host(x) -> np.ndarray:
    """A kept answer, off the device, so that it holds none of its memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class Window:
    latencies: list = field(default_factory=list)  # seconds, each solve
    infos: list = field(default_factory=list)  # the program's SolveInfo
    kept: list = field(default_factory=list)  # (solve index, host answer)
    wall_s: float = 0.0  # first send to last return

    @property
    def solve_s(self) -> float:
        """Seconds a solve: every solve's latency, summed, over their
        number. The caller's own work between solves (drawing the next
        right-hand side, keeping an answer) is not the program's."""
        return sum(self.latencies) / len(self.latencies)


def closed_loop(solve, rhs: Rhs, first: int, seconds: float, device,
                keep: int, rng: np.random.Generator) -> Window:
    """Back-to-back solves from one caller, solve ``k`` on ``rhs.draw(k)``
    from ``k = first``, until ``seconds`` have passed; the solve under way
    then finishes and counts. Each latency runs from the call to the
    device's synchronise after it."""
    w = Window()
    t0 = None
    n = 0
    while True:
        b = rhs.draw(first + n)
        sync(device)
        ts = time.perf_counter()
        if t0 is None:
            t0 = ts
        x, info = solve(b)
        sync(device)
        te = time.perf_counter()
        w.latencies.append(te - ts)
        w.infos.append(info)
        j = n if n < keep else int(rng.integers(0, n + 1))
        if j < keep:
            item = (first + n, to_host(x))
            if n < keep:
                w.kept.append(item)
            else:
                w.kept[j] = item
        del x
        n += 1
        if te - t0 >= seconds:
            break
    w.wall_s = te - t0
    return w
