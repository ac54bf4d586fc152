"""Per-phase wall-clock timers.

The reference has no timing at all — its only clock is the decorative
progress-bar ETA (reference src/progressbar.rs:21-35, dead code). Here
every render can report where the wall time went: scene build, BVH /
kernel-record build, the compile-carrying first dispatch, steady-state
dispatches, and image encode. `--timers` on the CLI prints the summary;
`jax.profiler` (`--profile`) remains the deep-dive tool.

Timing rule: JAX returns before the device finishes, so a phase must end
at a device sync — every call site here encloses the host-side
materialization of its result (`np.asarray`).
"""

from __future__ import annotations

import time


class Timers:
    """Accumulating named phase timers.

    >>> t = Timers()
    >>> with t.phase("build"):
    ...     pass
    >>> "build" in t.summary()
    True
    """

    def __init__(self):
        self._acc: dict[str, float] = {}

    def phase(self, name: str) -> "_Phase":
        return _Phase(self, name)

    def add(self, name: str, seconds: float) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    def summary(self) -> dict[str, float]:
        """Phase → accumulated seconds (insertion order), rounded."""
        return {k: round(v, 4) for k, v in self._acc.items()}

    def report(self) -> str:
        total = sum(self._acc.values()) or 1.0
        lines = [f"  {k:<16s} {v:8.3f}s  {100.0 * v / total:5.1f}%"
                 for k, v in self.summary().items()]
        return "\n".join(lines)


class _Phase:
    def __init__(self, timers: Timers, name: str):
        self._timers = timers
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timers.add(self._name, time.perf_counter() - self._t0)
        return False
