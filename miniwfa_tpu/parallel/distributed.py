"""Multi-host initialization and the data-parallel scaling recipe.

The reference is single-process (SURVEY.md §2 parallelism inventory); the
scale-out here is a pair stream sharded across all devices of all hosts:
``init()`` brings up ``jax.distributed``, ``global_mesh()`` builds the 1-D
data mesh over every device in the job, and ``align_batch_sharded`` runs
over it, every device running its own lanes with no collective inside
the compiled program.

Multi-process contract (implemented in parallel/batch.py): small per-lane
outputs are ``process_allgather``'d so every process returns them for
every pair; traceback/snapshot buffers are fetched per lane from the
LOCAL addressable shard only (never the whole global array), and low-mem
checkpoint lists are exchanged with ``_sync_segs`` so pass-2 inputs are
identical across processes.  tests/test_multiprocess.py runs a real
2-process ``jax.distributed`` job over this path.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from .mesh import make_mesh


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for a multi-host run.

    With no arguments, reads the standard JAX env vars / cluster
    autodetection; single-process runs are a no-op.
    """
    n = num_processes if num_processes is not None else int(
        os.environ.get("MWF_NUM_PROCESSES", "1"))
    if n <= 1 and coordinator_address is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "data"):
    """1-D mesh over every device in the job (all chips, all hosts)."""
    return make_mesh(jax.devices(), axis)
