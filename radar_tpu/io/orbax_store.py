"""Orbax-backed distributed checkpointing (SURVEY.md section 5.4).

The npz ``CheckpointStore`` (io/checkpoint.py) mirrors the reference's
per-stage ``.mat`` persistence for host arrays. This module adds the
device-side half the reference has no counterpart for: checkpointing
SHARDED device arrays — each host/device writes its own shards (no
all-gather to host 0), and restore re-materializes the arrays with the
same ``jax.sharding`` layout, so a multi-chip frame loop or streaming
Monte-Carlo can resume without ever forming the global array in one
memory. Built on ``orbax.checkpoint`` (async-capable, the standard JAX
ecosystem checkpointer).

Same frame-keyed layout and ``frames_done``/resume semantics as the npz
store (ref: the save_options stage persistence of
main_test_with_simulated_data.m:26-35,143-163 and the
frame_sim_array_N.mat replay files of
main_simulate_echoes_with_array.m:225-229).
"""

from __future__ import annotations

import os
import re

import jax
import numpy as np


_FRAME_RE = re.compile(r"^frame_(\d+)$")


class OrbaxFrameStore:
    """Frame-keyed pytree checkpoints; sharded arrays stay sharded.

    save/restore operate on pytrees of (possibly distributed) jax.Arrays
    or numpy arrays. Restore with ``like=`` (a pytree of abstract
    ``jax.ShapeDtypeStruct`` with shardings, or concrete arrays) to get
    the checkpoint back with the given distributed layout; without
    ``like`` the arrays come back host-local.
    """

    def __init__(self, root: str):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, frame_idx: int) -> str:
        return os.path.join(self.root, f"frame_{frame_idx:06d}")

    def save(self, frame_idx: int, tree, *, force: bool = True) -> str:
        path = self._path(frame_idx)
        with self._ocp.PyTreeCheckpointer() as ckptr:
            ckptr.save(path, tree, force=force)
        return path

    def restore(self, frame_idx: int, like=None):
        path = self._path(frame_idx)
        with self._ocp.PyTreeCheckpointer() as ckptr:
            if like is None:
                # EXPLICIT host-local numpy restore. The bare
                # ckptr.restore(path) default takes orbax's
                # sharding-from-file path, which warns (correctly) that it
                # is unsafe when the restoring topology differs from the
                # saving one — exactly the elastic dp=N -> dp=M resume
                # this store exists for. Callers that want device arrays
                # pass ``like=`` with the CURRENT mesh's shardings; the
                # default never guesses a topology.
                meta_tree = ckptr.metadata(path).item_metadata.tree
                restore_args = jax.tree.map(
                    lambda _: self._ocp.RestoreArgs(restore_type=np.ndarray),
                    meta_tree)
                return ckptr.restore(
                    path, args=self._ocp.args.PyTreeRestore(
                        restore_args=restore_args))
            abstract = jax.tree.map(
                lambda x: x if isinstance(x, jax.ShapeDtypeStruct)
                else jax.ShapeDtypeStruct(
                    np.shape(x), np.asarray(x).dtype
                    if not isinstance(x, jax.Array) else x.dtype,
                    sharding=getattr(x, "sharding", None)), like)
            return ckptr.restore(
                path, args=self._ocp.args.PyTreeRestore(
                    restore_args=self._ocp.checkpoint_utils.construct_restore_args(
                        abstract)))

    def has(self, frame_idx: int) -> bool:
        return os.path.isdir(self._path(frame_idx))

    def frames_done(self) -> list[int]:
        """Sorted frame indices with complete checkpoints — the resume
        point scan (same contract as CheckpointStore.frames_done)."""
        done = []
        for name in os.listdir(self.root):
            m = _FRAME_RE.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                done.append(int(m.group(1)))
        return sorted(done)
