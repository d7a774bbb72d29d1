"""Data-parallel execution of the flagship perf path (SURVEY.md section 2.3
"trial/data parallelism"; the reference's only parallel boundary — the
``parfor`` trial loop at main_plot_snr_vs_angle_error.m:167 — mapped onto a
device mesh).

*Shard the batch, not the frame*: ``shard_map`` over the ``dp`` axis gives
every device its own slice of a frame/trial batch; inside the shard each
device runs the COMPLETE single-device perf pipeline as local compute with
no collectives in the hot loop, so N devices run N frames concurrently.

Contrast with parallel/sharded.py, which shards ONE frame across devices
(ch/cpi/range axes) to shrink latency and per-device memory; this module
shards MANY frames across devices to scale throughput. Both compose: the
mesh can carry a dp axis for this module alongside model axes for that one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config.params import RadarConfig
from ..pipeline.frame import make_frame_processor
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed
from .mesh import AXIS_CPI, AXIS_DP


def broadcast_targets(targets: TargetBatch, n: int) -> TargetBatch:
    """Tile one target set across a batch axis (Monte-Carlo trials: same
    truth, different noise keys)."""
    return jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[None], (n,) + jnp.shape(x)),
        targets)


def make_dp_frame_processor(cfg: RadarConfig, mesh: Mesh,
                            precomp: Precomputed | None = None,
                            dtype=jnp.complex64, axis: str = AXIS_DP):
    """Jitted ``process_batch(keys [N, ...], targets [N, K]) -> FrameResult
    batched [N]``, with the batch axis sharded over ``mesh`` axis ``axis``.

    ``keys`` is a batch of raw PRNG keys (``jax.random.PRNGKey`` stacked on
    a leading axis); ``targets`` a :class:`TargetBatch` whose leaves carry
    the same leading batch axis (see :func:`broadcast_targets`). N must be a
    multiple of the ``axis`` size. Each device runs the full single-device
    pipeline for its ``N / n_dp`` frames sequentially under ``lax.map`` —
    one full-size frame already fills a device, and a sequential local loop
    keeps per-device memory at one frame's working set.

    Every result is bit-identical to running the single-device processor
    per frame (tests/test_dp.py): shard_map only changes WHERE each frame
    is computed.
    """
    process = make_frame_processor(cfg, precomp, dtype=dtype, jit=False)

    def local(keys, targets):
        return jax.lax.map(lambda kt: process(kt[0], kt[1]),
                           (keys, targets))

    # check_vma=False: the clustering fixpoint (cluster/connected.py) is a
    # while_loop whose initial flag is mesh-invariant while its update is
    # per-shard; correctness is covered by the parity tests
    f = shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis)),
                  out_specs=P(axis), check_vma=False)

    def process_batch(keys, targets: TargetBatch):
        n = keys.shape[0]
        n_dp = mesh.shape[axis]
        if n % n_dp:
            raise ValueError(f"batch {n} not divisible by {axis}={n_dp}")
        return f(keys, targets)

    return jax.jit(process_batch)


def make_dp_sharded_frame_processor(cfg: RadarConfig, mesh: Mesh,
                                    precomp: Precomputed | None = None,
                                    dtype=jnp.complex64, axis: str = AXIS_DP):
    """dp x model-parallel COMPOSITION: jitted ``process_batch(keys [N, ...],
    targets [N, K]) -> FrameResult batched [N]`` where the batch axis shards
    over the mesh ``dp`` axis and EACH frame is GSPMD-sharded over the
    remaining model axes (ch-sharded synthesis + psum DBF, cpi pulse/gate
    sharding with the all_to_all MTD reshard) — dp across hosts, ch/cpi
    within a host (parallel/multihost.py mesh order; SURVEY.md section 2.3
    composed strategies).

    Pure GSPMD: the single-frame sharded pipeline (parallel/sharded.py,
    built with ``frame_axes=(cpi,)`` so dp stays free for the batch) is
    vmapped over the batch axis; ``with_sharding_constraint``'s batching
    rule threads the inner ch/cpi constraints under the new dimension, and
    outer dp constraints on inputs/outputs pin the batch layout. Parity vs
    the per-frame single-device pipeline: tests/test_dp.py."""
    from .sharded import make_sharded_frame_processor

    process = make_sharded_frame_processor(cfg, mesh, precomp, dtype=dtype,
                                           jit=False,
                                           frame_axes=(AXIS_CPI,))
    vproc = jax.vmap(process)

    def lead(x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(axis)))

    def process_batch(keys, targets: TargetBatch):
        n = keys.shape[0]
        n_dp = mesh.shape[axis]
        if n % n_dp:
            raise ValueError(f"batch {n} not divisible by {axis}={n_dp}")
        out = vproc(lead(keys), jax.tree.map(lead, targets))
        return jax.tree.map(lead, out)

    return jax.jit(process_batch)


def make_dp_trial_fn(cfg: RadarConfig, mesh: Mesh,
                     precomp: Precomputed | None = None,
                     dtype=jnp.complex64, axis: str = AXIS_DP):
    """dp-sharded Monte-Carlo trial batch on the PERF path: jitted
    ``trials(targets, keys [T, ...]) -> (angles [T], hits [T])`` matching
    pipeline/montecarlo.py's contract (first final target's angle, NaN on
    miss) but with trials sharded over the mesh ``axis`` and the full
    pipeline running per device. ``targets`` is ONE target set (un-batched);
    the signal factors are recomputed per trial — at rank K<=8 that is a few
    microseconds against a multi-ms frame."""
    from ..pipeline.montecarlo import _first_valid_angle

    process = make_frame_processor(cfg, precomp, dtype=dtype, jit=False)

    def local(keys, targets):
        def one(k):
            return _first_valid_angle(process(k, targets))
        return jax.lax.map(one, keys)

    f = shard_map(local, mesh=mesh, in_specs=(P(axis), P()),
                  out_specs=(P(axis), P(axis)), check_vma=False)

    def trials(targets: TargetBatch, keys):
        targets = jax.tree.map(jnp.asarray, targets)
        return f(keys, targets)

    return jax.jit(trials)
