"""Device-mesh construction for the distributed radar pipeline (SURVEY.md
section 2.3 — no reference counterpart: the reference is single-process
MATLAB with one ``parfor``).

Mesh axes and their radar meaning:

  - ``dp``:  data parallel — Monte-Carlo trials / frame batches
  - ``ch``:  channel parallel — array elements sharded across devices; the
             DBF channel-combine and MUSIC covariance become psum reductions
             (TP analog)
  - ``cpi``: slow-time parallel — pulse blocks of a CPI sharded; MTD needs a
             resharding transpose (sequence-parallel analog)

On a multi-GPU host every card reaches every other over NVLink at the same
rate, so the mesh follows the algorithm alone: ``make_mesh`` reshapes the
default device order. Across hosts (jax.distributed) the dp axis goes
first, so the only cross-host traffic is the batch split.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


AXIS_DP = "dp"
AXIS_CH = "ch"
AXIS_CPI = "cpi"


def make_mesh(dp: int = 1, ch: int = 1, cpi: int = 1,
              devices=None) -> Mesh:
    """Build a (dp, ch, cpi) mesh over the first dp*ch*cpi devices."""
    n = dp * ch * cpi
    if devices is None:
        devices = jax.devices()
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(dp, ch, cpi)
    return Mesh(arr, (AXIS_DP, AXIS_CH, AXIS_CPI))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def spec(mesh: Mesh, *axes) -> NamedSharding:
    """NamedSharding with one entry per array dim; None = replicated dim."""
    return NamedSharding(mesh, P(*axes))
