"""Timing, GCUPS accounting, and profiler integration.

The replacement of the reference's observability surface
(/root/reference/host/src/utils.c:89-97 `dwalltime`, the GCUPS report at
FPGAsearch.c:311-331 / HybridSearch.c:1213-1234, and the unused OpenCL
event profiling helper AOCL_Utils.cpp:495-505):

- `Metrics`: named phase wall-timers (preprocess / profile-build / search /
  topk ...) with counts, totals, and a report, replacing the scattered
  dwalltime() pairs.
- `gcups`: the reference's throughput metric, Q*D / (t * 1e9) over TRUE
  residues.
- `profile_trace`: context manager around `jax.profiler.trace` — the
  analog of CL_QUEUE_PROFILING_ENABLE event timestamps; produces a trace
  viewable in TensorBoard/Perfetto instead of printf timing.
"""

import contextlib
import time
from collections import defaultdict


def gcups(query_residues: int, db_residues: int, seconds: float) -> float:
    """GCUPS = Q * D / (t * 1e9) (FPGAsearch.c:324)."""
    if seconds <= 0:
        return float("inf")
    return query_residues * db_residues / (seconds * 1e9)


class Metrics:
    """Named wall-clock phase accumulator.

    >>> m = Metrics()
    >>> with m.phase("search"):
    ...     pass
    >>> m.total("search") >= 0
    True
    """

    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1

    def add(self, name: str, seconds: float):
        self._totals[name] += seconds
        self._counts[name] += 1

    def total(self, name: str) -> float:
        return self._totals[name]

    def count(self, name: str) -> int:
        return self._counts[name]

    def report(self) -> str:
        lines = []
        for name in sorted(self._totals):
            t, c = self._totals[name], self._counts[name]
            avg = f", avg {t / c * 1e3:.2f} ms" if c > 1 else ""
            lines.append(f"{name}:\t{t:.4f} s (x{c}{avg})")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": self._totals[k], "count": self._counts[k]}
                for k in self._totals}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a JAX/XLA device trace for the enclosed block."""
    import jax
    with jax.profiler.trace(log_dir):
        yield
