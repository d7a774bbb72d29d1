"""Orbax-backed distributed checkpointing (io/orbax_store.py):
sharded arrays round-trip WITH their sharding on the 8-device mesh, and
the frames_done resume contract matches the npz store's
(SURVEY.md section 5.4 — the device-side half the reference's .mat
persistence has no counterpart for)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from radar_tpu.io.orbax_store import OrbaxFrameStore
from radar_tpu.parallel.mesh import AXIS_CH, AXIS_CPI, make_mesh


def test_sharded_roundtrip_preserves_layout(tmp_path):
    mesh = make_mesh(dp=1, ch=2, cpi=4)
    sh = NamedSharding(mesh, P(None, AXIS_CPI, AXIS_CH))
    x = jnp.arange(3 * 8 * 16, dtype=jnp.float32).reshape(3, 8, 16)
    xs = jax.device_put(x, sh)
    tree = {"rdm": xs, "frame_idx": np.int32(7),
            "servo_deg": np.float32(123.25)}

    store = OrbaxFrameStore(str(tmp_path / "ckpt"))
    store.save(7, tree)

    # restore with the SAME distributed layout (no host gather)
    like = {"rdm": jax.ShapeDtypeStruct(xs.shape, xs.dtype, sharding=sh),
            "frame_idx": np.int32(0), "servo_deg": np.float32(0)}
    back = store.restore(7, like=like)
    assert back["rdm"].sharding == sh
    np.testing.assert_array_equal(np.asarray(back["rdm"]), np.asarray(x))
    assert int(back["frame_idx"]) == 7
    assert float(back["servo_deg"]) == 123.25

    # restore host-local (no like) also reproduces the values
    host = store.restore(7)
    np.testing.assert_array_equal(np.asarray(host["rdm"]), np.asarray(x))


def test_frames_done_resume_contract(tmp_path):
    store = OrbaxFrameStore(str(tmp_path / "ckpt"))
    assert store.frames_done() == []
    for i in (0, 2, 5):
        store.save(i, {"x": np.arange(4, dtype=np.float32) + i})
    assert store.frames_done() == [0, 2, 5]
    assert store.has(2) and not store.has(1)
    # resume point = first missing frame, same scan the npz store's
    # frames_done enables (pipeline restart-on-failure, SURVEY 5.3)
    done = store.frames_done()
    resume = next(i for i in range(10) if i not in done)
    assert resume == 1
    np.testing.assert_array_equal(store.restore(5)["x"],
                                  np.arange(4, dtype=np.float32) + 5)


def test_restore_with_different_sharding(tmp_path):
    """A checkpoint written with one layout restores under another —
    the elastic-recovery case (restart on a different mesh shape)."""
    mesh = make_mesh(dp=1, ch=2, cpi=4)
    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    xs = jax.device_put(x, NamedSharding(mesh, P(AXIS_CH, AXIS_CPI)))
    store = OrbaxFrameStore(str(tmp_path / "ckpt"))
    store.save(0, {"x": xs})

    mesh2 = make_mesh(dp=1, ch=4, cpi=2)
    sh2 = NamedSharding(mesh2, P(AXIS_CPI, AXIS_CH))
    back = store.restore(0, like={
        "x": jax.ShapeDtypeStruct((8, 8), jnp.float32, sharding=sh2)})
    assert back["x"].sharding == sh2
    np.testing.assert_array_equal(np.asarray(back["x"]), np.asarray(x))
