"""Platform/device discovery and memory accounting.

Role of the reference's RT system layer (SURVEY §2d):

- ``PlatformManager`` (``system/PlatformManager.cpp:23-57``): enumerate
  compute devices, pick the best one, expose device info to the UI — here a
  thin view over ``jax.devices()`` with device memory stats.
- ``RTBufferManager`` (``system/RTBufferManager.h:21-71``): tracked, named
  allocation contexts with total/max statistics — here ``BufferManager``
  registers pytrees-of-arrays under named contexts and reports per-context
  and device-wide byte totals (the data the reference's GUI shows at
  ``PathTracingGUI.cpp:110-114``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax


@dataclass(frozen=True)
class DeviceInfo:
    index: int
    platform: str
    kind: str
    memory_bytes: int | None  # HBM limit if known


def enumerate_devices() -> list[DeviceInfo]:
    """Device discovery (``PlatformManager::init`` analogue)."""
    out = []
    for i, d in enumerate(jax.devices()):
        mem = None
        try:
            stats = d.memory_stats()
            if stats:
                mem = stats.get("bytes_limit")
        except Exception:
            pass
        out.append(
            DeviceInfo(index=i, platform=d.platform,
                       kind=getattr(d, "device_kind", "?"), memory_bytes=mem)
        )
    return out


def device_memory_stats(index: int = 0) -> dict:
    """Live HBM usage for one device (GUI memory-readout analogue)."""
    try:
        return dict(jax.devices()[index].memory_stats() or {})
    except Exception:
        return {}


def _nbytes(tree) -> int:
    return sum(
        getattr(leaf, "nbytes", 0) for leaf in jax.tree.leaves(tree)
    )


@dataclass
class BufferManager:
    """Named allocation contexts with total/max stats
    (``RTBufferManager`` analogue: the reference tracks every CL buffer
    under a memory-record context and surfaces totals in the GUI)."""

    contexts: dict[str, int] = field(default_factory=dict)
    max_total: int = 0

    def register(self, name: str, tree) -> int:
        """Track a pytree of arrays under `name`; returns its byte size."""
        size = _nbytes(tree)
        self.contexts[name] = self.contexts.get(name, 0) + size
        self.max_total = max(self.max_total, self.total)
        return size

    def release(self, name: str) -> None:
        self.contexts.pop(name, None)

    @property
    def total(self) -> int:
        return sum(self.contexts.values())

    def report(self) -> str:
        lines = [
            f"  {name:<24} {size / 2**20:8.2f} MiB"
            for name, size in sorted(self.contexts.items())
        ]
        lines.append(f"  {'TOTAL':<24} {self.total / 2**20:8.2f} MiB"
                     f" (max {self.max_total / 2**20:.2f})")
        return "\n".join(lines)


# module-level default manager (the reference's globals, rt_globals.h:5-9)
buffers = BufferManager()
