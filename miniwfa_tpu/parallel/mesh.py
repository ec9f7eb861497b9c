"""Device mesh helpers.

The workload is a stream of independent pair alignments, so the natural
mesh is one data axis over all devices and hosts: lanes of a batch shard
across 'data'; each device runs its own wavefront loop; per-lane
results are gathered on the host (the reference is single-threaded —
SURVEY.md §2 parallelism inventory maps scale-out to exactly this)."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data") -> Mesh:
    """A 1-D mesh over the given (default: all) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis,))


def data_parallel_devices() -> int:
    return len(jax.devices())
