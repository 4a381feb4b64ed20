"""Profiling spans + renderer metrics.

Analogue of the reference's ``QueryManager``
(``engine/util/QueryManager.h``, 441 LoC): named hierarchical CPU+GPU spans
with per-frame / max / average histories, surfaced in the stats GUI
(``StatsWindow.cpp:12-49``).  Here:

- host spans: a lightweight RAII span registry with the same
  per-interval max/avg histories (``ScopedProfiling`` analogue);
- device time: wrap ``jax.profiler`` traces (Perfetto) and
  ``jax.named_scope`` for XLA-visible names — how device time is
  attributed here, instead of GL timestamp queries;
- renderer metrics: rays/s, spp, memory-per-chip (``RTBufferManager``
  stats role, ``RTBufferManager.h:21-71``).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import jax


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    last_s: float = 0.0
    history: list = field(default_factory=list)

    @property
    def avg_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Profiler:
    """Named span registry (``QueryManager`` role). Spans nest via '/'."""

    def __init__(self, history: int = 64):
        self._stats: dict[str, SpanStats] = defaultdict(SpanStats)
        self._stack: list[str] = []
        self._history = history

    @contextlib.contextmanager
    def span(self, name: str, sync: jax.Array | None = None):
        """Time a host-side span; pass a jax array as `sync` to block on it
        (device work is async — without a sync you time dispatch only)."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with jax.named_scope(name):
                yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self._stack.pop()
            s = self._stats[path]
            s.count += 1
            s.total_s += dt
            s.last_s = dt
            s.max_s = max(s.max_s, dt)
            s.history.append(dt)
            if len(s.history) > self._history:
                s.history.pop(0)

    def stats(self) -> dict[str, SpanStats]:
        return dict(self._stats)

    def report(self) -> str:
        lines = [f"{'span':40s} {'count':>6s} {'last ms':>9s} {'avg ms':>9s} {'max ms':>9s}"]
        for name in sorted(self._stats):
            s = self._stats[name]
            lines.append(
                f"{name:40s} {s.count:6d} {s.last_s*1e3:9.2f} "
                f"{s.avg_s*1e3:9.2f} {s.max_s*1e3:9.2f}"
            )
        return "\n".join(lines)

    def reset(self):
        self._stats.clear()


# module-level default profiler (the reference's QueryManager is a singleton)
profiler = Profiler()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profile (Perfetto/TensorBoard) around a block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> dict:
    """Per-device memory stats (``RTBufferManager`` totals/max role)."""
    out = {}
    for d in jax.devices():
        try:
            ms = d.memory_stats()
        except Exception:
            ms = None
        if ms:
            out[str(d)] = {
                "bytes_in_use": ms.get("bytes_in_use", 0),
                "peak_bytes_in_use": ms.get("peak_bytes_in_use", 0),
                "bytes_limit": ms.get("bytes_limit", 0),
            }
    return out


@dataclass
class RenderMetrics:
    """Rolling renderer metrics (GUI spp/render-time readout analogue,
    ``PathTracingGUI.cpp:116-117``)."""

    rays_traced: float = 0.0
    samples: int = 0
    render_s: float = 0.0

    def rays_per_sec(self) -> float:
        return self.rays_traced / max(self.render_s, 1e-9)
