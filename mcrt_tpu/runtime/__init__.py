"""Runtime layer: platform/device discovery, buffer accounting, native lib.

Replacement for the reference's RT system layer
(``source/application/PathTracer/raytracing/system/``): ``PlatformManager``
-> :mod:`.platform` device enumeration; ``RTBufferManager`` -> tracked
:class:`~.platform.BufferManager`; ``KernelManager``'s compile cache is
XLA's own jit cache (persistent compilation cache configurable via
``jax.config``); the native host library lives in :mod:`.native`.
"""
from .platform import (  # noqa: F401
    BufferManager,
    DeviceInfo,
    buffers,
    device_memory_stats,
    enumerate_devices,
)
