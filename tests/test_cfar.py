"""CFAR detector parity: cell-exact masks vs the per-cell-loop oracle (the
NumPy port of fun_run_goca_cfar_8, SURVEY.md section 7.3 step 4), plus
fixed-capacity detection extraction semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

from radar_tpu.config.params import CfarParams
from radar_tpu.ops.cfar import (extract_detections, first_k_true_indices,
                                goca_cfar_2d, pair_sum_maps)
from oracle import goca_cfar_oracle


def _planted_maps(rng, num_v=48, num_r=96, pairs=3, n_peaks=6):
    maps = rng.exponential(scale=1.0, size=(num_v, num_r, pairs))
    for _ in range(n_peaks):
        v = rng.integers(8, num_v - 8)
        r = rng.integers(16, num_r - 16)
        p = rng.integers(0, pairs)
        maps[v, r, p] += rng.uniform(30, 100)
    return maps


@pytest.mark.parametrize("method", ["GOCA", "SOCA", "CA"])
def test_cfar_mask_cell_exact(method):
    rng = np.random.default_rng(11)
    maps = _planted_maps(rng)
    params = CfarParams(ref_cells_v=3, guard_cells_v=4, ref_cells_r=5,
                        guard_cells_r=10, threshold_factor=8.0, method=method)
    mask, _ = goca_cfar_2d(jnp.asarray(maps), params)
    want = goca_cfar_oracle(maps, params.ref_cells_r, params.guard_cells_r,
                            params.ref_cells_v, params.guard_cells_v,
                            params.threshold_factor, method)
    np.testing.assert_array_equal(np.asarray(mask), want)
    assert want.sum() > 0  # the planted peaks are detected


def test_cfar_border_cells_never_detect():
    params = CfarParams(ref_cells_v=3, guard_cells_v=4, ref_cells_r=5,
                        guard_cells_r=10)
    maps = np.zeros((40, 80, 1))
    maps[2, 3, 0] = 1e9     # inside the border zone
    maps[39, 79, 0] = 1e9
    mask, _ = goca_cfar_2d(jnp.asarray(maps), params)
    assert not bool(np.asarray(mask).any())


def test_pair_sum_maps():
    rng = np.random.default_rng(5)
    rdm = rng.normal(size=(8, 10, 4)) + 1j * rng.normal(size=(8, 10, 4))
    maps = np.asarray(pair_sum_maps(jnp.asarray(rdm)))
    assert maps.shape == (8, 10, 3)
    np.testing.assert_allclose(maps[..., 1],
                               np.abs(rdm[..., 1]) + np.abs(rdm[..., 2]),
                               rtol=1e-12)


def test_extract_detections_order_and_capacity():
    """Extraction order is (pair, range, velocity)-major — MATLAB's
    column-major find per pair (ref :215-221) — and capacity clipping keeps
    the earliest entries with the true count reported."""
    num_v, num_r, pairs = 8, 10, 2
    mask = np.zeros((num_v, num_r, pairs), bool)
    maps = np.arange(num_v * num_r * pairs, dtype=float).reshape(
        num_v, num_r, pairs)
    hits = [(3, 2, 0), (5, 2, 0), (1, 7, 0), (2, 1, 1)]
    for v, r, p in hits:
        mask[v, r, p] = True
    dets = extract_detections(jnp.asarray(mask), jnp.asarray(maps),
                              capacity=8)
    got = [(int(v), int(r), int(p)) for v, r, p, ok in zip(
        dets.v_idx, dets.r_idx, dets.pair_idx, dets.valid) if ok]
    # sorted by (pair, r, v)
    assert got == sorted(hits, key=lambda t: (t[2], t[1], t[0]))
    assert int(dets.count) == 4
    for v, r, p in got:
        pass
    amps = np.asarray(dets.amp)[np.asarray(dets.valid)]
    np.testing.assert_allclose(
        amps, [maps[v, r, p] for v, r, p in got], rtol=1e-12)

    # capacity clipping: keep first 2 in order, count still 4
    dets2 = extract_detections(jnp.asarray(mask), jnp.asarray(maps),
                               capacity=2)
    got2 = [(int(v), int(r), int(p)) for v, r, p, ok in zip(
        dets2.v_idx, dets2.r_idx, dets2.pair_idx, dets2.valid) if ok]
    assert got2 == sorted(hits, key=lambda t: (t[2], t[1], t[0]))[:2]
    assert int(dets2.count) == 4


def test_first_k_true_indices_random():
    """Direct unit test of the hierarchical first-K extraction vs
    np.nonzero across densities, row-boundary straddles, and overflow."""
    from radar_tpu.ops.cfar import first_k_true_indices

    rng = np.random.default_rng(0)
    for density, cap in [(0.0, 16), (1e-4, 64), (5e-3, 32), (0.5, 8)]:
        flat = rng.uniform(size=20000) < density
        idx, valid = first_k_true_indices(jnp.asarray(flat), cap,
                                          row_width=512)
        want = np.nonzero(flat)[0]
        got = np.asarray(idx)[np.asarray(valid)]
        np.testing.assert_array_equal(got, want[:cap])
        assert int(np.asarray(valid).sum()) == min(len(want), cap)
    # hits exactly at row boundaries
    flat = np.zeros(4096, bool)
    flat[[0, 511, 512, 1023, 1024, 4095]] = True
    idx, valid = first_k_true_indices(jnp.asarray(flat), 8, row_width=512)
    np.testing.assert_array_equal(np.asarray(idx)[np.asarray(valid)],
                                  [0, 511, 512, 1023, 1024, 4095])


def test_extract_native_scan_matches_default():
    rng = np.random.default_rng(9)
    mask = rng.uniform(size=(32, 200, 5)) < 0.004  # ~128 hits, under cap
    maps = rng.uniform(1.0, 9.0, size=(32, 200, 5))
    a = extract_detections(jnp.asarray(mask), jnp.asarray(maps), 256)
    b = extract_detections(jnp.asarray(mask), jnp.asarray(maps), 256,
                           native_scan=True)
    for f in ("v_idx", "r_idx", "pair_idx", "amp", "valid", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@settings(max_examples=40, deadline=None)
@given(st.data())
@pytest.mark.slow
def test_first_k_true_property(data):
    """For ANY boolean vector, first_k_true_indices returns exactly the
    first min(count, capacity) true positions in ascending order."""
    from radar_tpu.ops.cfar import first_k_true_indices

    n = data.draw(st.integers(1, 3000))
    density = data.draw(st.floats(0.0, 0.2))
    seed = data.draw(st.integers(0, 2**31))
    cap = data.draw(st.sampled_from([1, 4, 32, 128]))
    rw = data.draw(st.sampled_from([64, 256, 4096]))
    rng = np.random.default_rng(seed)
    flat = rng.uniform(size=n) < density
    idx, valid = first_k_true_indices(jnp.asarray(flat), cap, row_width=rw)
    idx, valid = np.asarray(idx), np.asarray(valid)
    want = np.flatnonzero(flat)[:cap]
    assert valid.sum() == len(want)
    np.testing.assert_array_equal(idx[:len(want)], want)
    assert np.all(idx[len(want):] == 0)


def test_first_k_true_vgq_matches_rowfetch():
    """extract_impl='direct' (producer-layout (pair,gate)-row extraction)
    is bit-identical to the rowfetch path across densities, including
    over-capacity."""
    import jax

    from radar_tpu.ops.cfar import first_k_true_vgq

    rng = np.random.default_rng(7)
    for density, cap in [(0.0, 64), (1e-4, 64), (2e-3, 64), (0.3, 128)]:
        mask = rng.random((48, 500, 6)) < density
        flat = jnp.transpose(jnp.asarray(mask), (2, 1, 0)).ravel()
        a_idx, a_val = jax.jit(
            lambda f: first_k_true_indices(f, cap))(flat)
        b_idx, b_val = jax.jit(
            lambda m: first_k_true_vgq(m, cap))(jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(a_idx), np.asarray(b_idx))
        np.testing.assert_array_equal(np.asarray(a_val), np.asarray(b_val))


def test_extract_impl_direct_in_pipeline():
    """Full small-config pipeline with extract_impl='direct' produces the
    identical FrameResult to the default."""
    import jax

    from radar_tpu.config.params import small_test_config
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.sim.scenario import TargetBatch

    cfg = small_test_config()
    tb = TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                          [18.0, 15.0])
    key = jax.random.PRNGKey(0)
    a = make_frame_processor(cfg)(key, tb)
    b = make_frame_processor(cfg.replace(extract_impl="direct"))(key, tb)
    assert int(a.num_raw_detections) == int(b.num_raw_detections)
    for fa, fb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_tail_from_rdm_in_pipeline():
    """cfg.tail_from_rdm (amplitudes/stencils gathered pointwise from the
    complex RDM, no materialized maps in the tail) produces the identical
    FrameResult. Ships default-off."""
    import jax

    from radar_tpu.config.params import small_test_config
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.sim.scenario import TargetBatch

    cfg = small_test_config()
    tb = TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                          [18.0, 15.0])
    key = jax.random.PRNGKey(0)
    a = make_frame_processor(cfg)(key, tb)
    b = make_frame_processor(cfg.replace(tail_from_rdm=True))(key, tb)
    for fa, fb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_cfar_matmul_means_variant():
    """The banded-stencil matmul window means (CfarParams.means_impl='matmul')
    reproduce the shift-add masks everywhere except cells within float
    rounding of the threshold (f32 summation-order tolerance, documented on
    lead_trail_means_matmul). In f64 test precision no cell sits that close
    for seeded data, so the masks are identical."""
    from radar_tpu.ops.cfar import lead_trail_means, lead_trail_means_matmul

    rng = np.random.default_rng(23)
    maps = jnp.asarray(_planted_maps(rng, num_v=40, num_r=300, pairs=4))
    l1, t1 = lead_trail_means(maps, 10, 5, axis=1)
    l2, t2 = lead_trail_means_matmul(maps, 10, 5, axis=1)
    np.testing.assert_allclose(np.asarray(l2), np.asarray(l1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t1),
                               rtol=1e-12, atol=1e-12)

    params = CfarParams(ref_cells_v=3, guard_cells_v=4, ref_cells_r=5,
                        guard_cells_r=10, threshold_factor=8.0)
    mask_s, _ = goca_cfar_2d(maps, params)
    mask_m, _ = goca_cfar_2d(maps, params.__class__(**{
        **params.__dict__, "means_impl": "matmul"}))
    np.testing.assert_array_equal(np.asarray(mask_m), np.asarray(mask_s))
