"""Multi-host (multi-process) bring-up for runs that span several hosts.

No reference counterpart (the reference is one MATLAB process; SURVEY.md
section 2.3 / 5.8) — this is the cross-host half of the design: each host
process calls :func:`initialize` once, builds the global mesh with the
cross-host axis first via :func:`make_multihost_mesh`, and then the existing
GSPMD-sharded pipeline (parallel/sharded.py) runs unchanged — jit over a
multi-host mesh is the supported JAX path for cross-host collectives.

Testable single-host: ``initialize()`` is a no-op when no coordinator is
configured, and ``make_multihost_mesh`` degenerates to the local mesh.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh

from .mesh import AXIS_CH, AXIS_CPI, AXIS_DP


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Bring up jax.distributed if multi-process coordinates are available.

    Resolution order: explicit arguments, then the standard environment
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``,
    or the cluster auto-detection built into jax.distributed). Returns
    True when a multi-process runtime was
    initialized, False for the single-process fallback. Idempotent."""
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # single-process run (tests, one host): nothing to do
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_multihost_mesh(dp: int | None = None, ch: int = 1,
                        cpi: int = 1) -> Mesh:
    """Global mesh over ALL processes' devices, cross-host axis first.

    Axis order puts ``dp`` (Monte-Carlo trials / frame batches — the only
    axis whose collectives are a cheap final gather) outermost so it maps
    across hosts, while ``ch``/``cpi`` (whose psum/all_to_all collectives
    are latency-critical, parallel/collectives.py) stay within a host.
    ``dp=None`` takes whatever device count remains."""
    devices = jax.devices()  # globally consistent order across processes
    n = len(devices)
    if dp is None:
        if n % (ch * cpi):
            raise ValueError(f"{n} devices not divisible by ch*cpi"
                             f"={ch * cpi}")
        dp = n // (ch * cpi)
    want = dp * ch * cpi
    if want > n:
        raise ValueError(f"need {want} devices, have {n}")
    arr = np.asarray(devices[:want]).reshape(dp, ch, cpi)
    return Mesh(arr, (AXIS_DP, AXIS_CH, AXIS_CPI))


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """Half-open slice of the global dp batch owned by this process — for
    feeding per-host shards to jax.make_array_from_process_local_data."""
    dp = mesh.shape[AXIS_DP]
    if global_batch % dp:
        raise ValueError(f"batch {global_batch} not divisible by dp={dp}")
    per = global_batch // dp
    # which dp rows live on this process
    rows = sorted({
        int(np.argwhere(mesh.devices == d)[0][0])
        for d in jax.local_devices() if d in mesh.devices.ravel().tolist()
    })
    if not rows:
        return slice(0, 0)
    return slice(rows[0] * per, (rows[-1] + 1) * per)
