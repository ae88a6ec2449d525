"""Logical devices for the mesh: the counterpart of the JAX package's
`utils/platform.py::force_cpu_devices`, which gives JAX n virtual CPU
devices.

`force_virtual_devices(n)` is a process-wide setting for tests and the
smoke test: after it, `executor.sharding.make_mesh` lays up to n logical
devices over the cards there are, round-robin (logical device c on
cuda:(c mod cards)), so that the mesh's placement, per-device launches,
merges and exchange run on one card. Without it, a mesh of more devices
than cards raises ValueError. A mesh on the CPU needs neither: it is D
entries of the CPU device.
"""

from __future__ import annotations

_virtual_devices = 0


def force_virtual_devices(n: int) -> None:
    """Allow meshes of up to `n` logical devices over the cards there
    are (n <= 0 restores the default: one logical device per card)."""
    global _virtual_devices
    _virtual_devices = max(0, int(n))


def virtual_devices() -> int:
    """The logical device count set by force_virtual_devices (0: none)."""
    return _virtual_devices
