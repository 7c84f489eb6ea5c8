"""Multi-chip sharding tests on a virtual 8-device CPU mesh
(SURVEY.md §4: shard_map logic without a pod)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuburn_tpu.models import sierpinski
from cuburn_tpu.profile import RenderProfile


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()[:8]


def test_mesh_creation(eight_devices):
    from cuburn_tpu.parallel import make_mesh
    mesh = make_mesh(8)
    assert mesh.devices.size == 8


def test_sharded_matches_single_chip_mass(eight_devices):
    """The sharded render must plot the same number of samples and
    produce an equivalent histogram distribution as single-chip."""
    from cuburn_tpu.parallel import ShardedRenderer
    from cuburn_tpu.render import Renderer

    g = sierpinski()
    prof = RenderProfile(width=64, height=64, quality=40, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=False, fuse=8)
    img_s, stats_s = ShardedRenderer(g, prof).render_frame(0.0, seed=3)
    img_1, stats_1 = Renderer(g, prof).render_frame(0.0, seed=3)

    assert stats_s.total_iters == stats_1.total_iters
    # retention should agree statistically (different RNG partitioning)
    assert stats_s.retention == pytest.approx(stats_1.retention,
                                              abs=0.05)
    # images statistically equivalent: compare mean brightness
    m_s = img_s[..., :3].astype(np.float64).mean()
    m_1 = img_1[..., :3].astype(np.float64).mean()
    assert m_s == pytest.approx(m_1, rel=0.15)


def test_sharded_scatter_sorted_matches_scatter(eight_devices):
    """The hinted-scatter backend through shard_map: same RNG stream
    as sharded scatter, so the histograms must match per-bin (density
    exact — pure reordering of integer counts)."""
    import dataclasses
    from cuburn_tpu.parallel import ShardedRenderer
    g = sierpinski()
    prof = RenderProfile(width=64, height=64, quality=30, batch=2048,
                         iters_per_chunk=8,
                         hist_backend="scatter_sorted",
                         de_enabled=False, fuse=8)
    h_o, st_o = ShardedRenderer(g, prof).accumulate(0.0, seed=3)
    prof_s = dataclasses.replace(prof, hist_backend="scatter")
    h_s, st_s = ShardedRenderer(g, prof_s).accumulate(0.0, seed=3)
    assert st_o.plotted_samples == st_s.plotted_samples
    a, b = np.asarray(h_s), np.asarray(h_o)
    np.testing.assert_array_equal(a[:, 3], b[:, 3])
    assert np.abs(a - b).max() < 1e-2


def test_sharded_temporal_single_dispatch_matches(eight_devices):
    """Sharded motion blur (one dispatch, packed interp, weighted
    samples) must statistically match the single-chip temporal path."""
    from cuburn_tpu.parallel import ShardedRenderer
    from cuburn_tpu.render import Renderer
    from cuburn_tpu.models import animated_spark

    g = animated_spark()
    g.temporal_filter_type = "gaussian"
    prof = RenderProfile(width=64, height=64, quality=40, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=False, fuse=8, temporal_samples=4)
    img_s, st_s = ShardedRenderer(g, prof).render_frame(0.5, seed=3)
    img_1, st_1 = Renderer(g, prof).render_frame(0.5, seed=3)
    assert st_s.total_iters == st_1.total_iters
    m_s = img_s[..., :3].astype(np.float64).mean()
    m_1 = img_1[..., :3].astype(np.float64).mean()
    assert m_s == pytest.approx(m_1, rel=0.15)


def test_stripe_parallel_accumulate_bitexact(eight_devices):
    """Stripe-parallel accumulation (one stripe per chip, identical
    replicated trajectory stream, zero collectives) must reproduce the
    single-chip striped accumulate bit for bit."""
    from cuburn_tpu.parallel import ShardedRenderer
    from cuburn_tpu.render import Renderer
    from cuburn_tpu.models import full_feature

    g = full_feature()
    prof = RenderProfile(width=64, height=64, quality=60, batch=2048,
                         iters_per_chunk=8, fuse=8,
                         hist_backend="scatter", de_enabled=False)
    sr = ShardedRenderer(g, prof)
    h_par, st_par = sr.accumulate_striped(0.0, seed=5)
    h_one, st_one = Renderer(g, prof).accumulate_striped(
        0.0, seed=5, n_stripes=8)
    np.testing.assert_array_equal(h_par[:-1], h_one[:-1])
    assert st_par.plotted_samples == st_one.plotted_samples
    assert st_par.total_iters == st_one.total_iters


def test_sharded_finalize_matches_single_chip(eight_devices):
    """Sharded filtering (each chip filters its own row band of the
    replicated histogram) must match the single-chip filter up to
    float reassociation (<= 1 u8 step) — with DE, supersampling,
    gutter, and a spatial filter in play."""
    import dataclasses
    from cuburn_tpu.genome.spline import Spline
    from cuburn_tpu.parallel import ShardedRenderer
    from cuburn_tpu.render import Renderer
    from cuburn_tpu.models import classic_swirl

    g = classic_swirl()
    g.estimator_radius = Spline(4.0)
    prof = RenderProfile(width=64, height=72, ss=2, quality=40,
                         batch=2048, iters_per_chunk=8, fuse=8,
                         hist_backend="scatter", de_enabled=True)
    sr = ShardedRenderer(g, prof)
    hist, st = sr.accumulate(0.0, seed=4)
    img_sharded = sr.finalize_frame(hist, 0.0, st)
    img_single = Renderer(g, prof).finalize_frame(hist, 0.0)
    assert img_sharded.shape == img_single.shape == (72, 64, 4)
    diff = np.abs(img_sharded.astype(int) - img_single.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_dryrun_multichip(eight_devices):
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_entry_compiles(eight_devices):
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_sharded_resume_mass_not_multiplied(eight_devices):
    """Resuming from a checkpoint histogram on an n-device mesh must
    ADD new samples to it, not multiply the resumed mass by n (the
    input replica must stay out of the psum)."""
    from cuburn_tpu.parallel import ShardedRenderer

    g = sierpinski()
    prof = RenderProfile(width=48, height=48, quality=30, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=False, fuse=8)
    r = ShardedRenderer(g, prof)
    h1, st1 = r.accumulate(0.0, seed=3)
    m1 = float(np.asarray(h1)[:, 3].sum())
    h2, st2 = r.accumulate(0.0, seed=3, hist0=np.asarray(h1))
    m2 = float(np.asarray(h2)[:, 3].sum())
    # total mass (incl. junk bin) is fixed by the iteration budget, so
    # resume = carry m1 ONCE + one fresh pass of the same budget = 2*m1
    assert m2 == pytest.approx(2.0 * m1, rel=1e-6)


def test_sharded_temporal_resume_mass(eight_devices):
    from cuburn_tpu.parallel import ShardedRenderer

    g = sierpinski()
    prof = RenderProfile(width=48, height=48, quality=30, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=False, fuse=8, temporal_samples=3)
    r = ShardedRenderer(g, prof)
    h1, st1 = r.accumulate(0.0, seed=3)
    m1 = float(np.asarray(h1)[:, 3].sum())
    h2, st2 = r.accumulate(0.0, seed=3, hist0=np.asarray(h1))
    m2 = float(np.asarray(h2)[:, 3].sum())
    assert m1 < m2 < 3.0 * m1


def test_sharded_overlapped_frames_identical(eight_devices):
    """The overlapped animation driver on a ShardedRenderer must use
    the sharded filter (finalize_frame_device override) and yield
    frames identical to the serial sharded driver."""
    from cuburn_tpu.models import animated_spark
    from cuburn_tpu.parallel import ShardedRenderer
    g = animated_spark()
    prof = RenderProfile(width=64, height=64, quality=15, batch=2048,
                         iters_per_chunk=8, fuse=8, fps=4.0,
                         duration=0.75, hist_backend="scatter",
                         de_enabled=False)
    r = ShardedRenderer(g, prof)
    serial = [(np.asarray(i), s) for i, s in
              (r.render_frame(t, seed=2 + k)
               for k, t in r.frame_times())]
    overlapped = list(r.frames_overlapped(seed=2))
    assert len(serial) == len(overlapped) == 3
    for (a, _), (b, sb) in zip(serial, overlapped):
        np.testing.assert_array_equal(a, b)
        assert sb.plotted_samples > 0


def test_sharded_frames_partitioned(eight_devices):
    """Animation through the partitioned paths on the mesh: striped
    accumulation (one stripe per chip) + banded finalize per frame."""
    from cuburn_tpu.models import animated_spark
    from cuburn_tpu.parallel import ShardedRenderer
    import dataclasses
    g = animated_spark()
    prof = RenderProfile(width=64, height=64, quality=15, batch=2048,
                         iters_per_chunk=8, fuse=8, fps=4.0,
                         duration=0.5, hist_backend="scatter",
                         de_enabled=False)
    r = ShardedRenderer(g, prof)
    frames = list(r.frames_partitioned(seed=2, n_stripes=8,
                                       n_bands=2))
    assert len(frames) == 2
    # parity against the SINGLE-CHIP whole-frame render (same
    # per-frame seeds): stripe-parallel replicates the single-chip
    # trajectory stream (unlike the sharded DP accumulate, which
    # partitions RNG lanes differently), striping is exact, banded
    # finalize within 1 u8 step — a band stitch that drops/doubles
    # rows cannot hide in a smoke check
    from cuburn_tpu.render import Renderer
    r1 = Renderer(g, prof)
    serial = [np.asarray(r1.render_frame(t, seed=2 + k)[0])
              for k, t in r1.frame_times()]
    for (img, stats), ref in zip(frames, serial):
        assert img.shape == (64, 64, 4)
        assert img[..., :3].max() > 0
        assert stats.plotted_samples > 0
        assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1


def test_sharded_dispatch_cap_parity(eight_devices):
    """dispatch_iter_cap on the sharded renderer (regression: the
    override ignored it, so a binding-size sharded frame ran as one
    long execution — the exact kill the cap exists to prevent).
    State/histogram carry across the capped calls of ONE
    traced-chunk-count program: the trajectory stream is identical, so
    density (integer counts) is bit-exact; RGB reassociates across the
    per-call psums (f32 rounding only)."""
    import dataclasses
    from cuburn_tpu.parallel import ShardedRenderer
    g = sierpinski()
    prof = RenderProfile(width=64, height=64, quality=40, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=False, fuse=8)
    h_uncapped, _ = ShardedRenderer(g, prof).accumulate(0.0, seed=5)
    prof_cap = dataclasses.replace(
        prof, dispatch_iter_cap=2048 * 8 * 3)   # 3 chunks per call
    h_capped, _ = ShardedRenderer(g, prof_cap).accumulate(0.0, seed=5)
    a, b = np.asarray(h_uncapped), np.asarray(h_capped)
    np.testing.assert_array_equal(a[:, 3], b[:, 3])
    np.testing.assert_allclose(a[:, :3], b[:, :3],
                               rtol=1e-5, atol=1e-3)


def test_sharded_batch_halving_keeps_divisibility(eight_devices):
    """The trajectory-lifetime batch cap must not halve the batch out
    of divisibility by the mesh size (regression: batch=16392 over 8
    devices would halve to 8196, 8196 % 8 != 0, and the P(BATCH_AXIS)
    device_put raises at render time)."""
    from cuburn_tpu.parallel import ShardedRenderer
    g = sierpinski()
    # 16392 = 8*2049: divisible by 8, above the 1024*8 floor, and one
    # halving would break divisibility; quality keeps iters/batch
    # under 8*fuse so the halving condition actually fires
    prof = RenderProfile(width=32, height=32, quality=100,
                         batch=16392, iters_per_chunk=16,
                         hist_backend="scatter", de_enabled=False,
                         fuse=8)
    r = ShardedRenderer(g, prof)
    assert prof.total_iters / prof.batch < 8 * prof.fuse
    assert r._halved_batch(prof.total_iters) % 8 == 0
    hist, stats = r.accumulate(0.0, seed=2)
    assert float(np.asarray(hist)[:-1, 3].sum()) > 0


def test_sharded_temporal_dispatch_cap_parity(eight_devices):
    """dispatch_iter_cap on a sharded MOTION-BLURRED frame: sample-
    group and per-chunk splits both reproduce the uncapped trajectory
    stream (density bit-exact; RGB reassociates across the per-call
    psums)."""
    import dataclasses
    from cuburn_tpu.models import animated_spark
    from cuburn_tpu.parallel import ShardedRenderer
    g = animated_spark()
    prof = RenderProfile(width=64, height=64, quality=40, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=False, fuse=8,
                         temporal_samples=4, fps=4.0, duration=1.0)
    h0, s0 = ShardedRenderer(g, prof).accumulate(0.5, seed=11)
    for cap in (2048 * 8 * 4, 2048 * 8):   # group split, chunk split
        prof_c = dataclasses.replace(prof, dispatch_iter_cap=cap)
        hc, sc = ShardedRenderer(g, prof_c).accumulate(0.5, seed=11)
        assert s0.total_iters == sc.total_iters
        a, b = np.asarray(h0), np.asarray(hc)
        np.testing.assert_array_equal(a[:, 3], b[:, 3])
        np.testing.assert_allclose(a[:, :3], b[:, :3],
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("backend",
                         ["scatter", "scatter_sorted", "sortcum"])
def test_scattered_mode_matches_replicated(eight_devices, backend):
    """Reduce-scatter mode (each chip owns only its filter band's
    reduced context block; ~half the interconnect bytes of the psum, 1/n
    post-reduction residency) must reproduce the replicated-psum
    render: same trajectory stream, same filter math — frames within
    one u8 step (reduction-order ulps), same plotted count."""
    from cuburn_tpu.models import full_feature
    from cuburn_tpu.parallel import ShardedRenderer
    g = full_feature()
    prof = RenderProfile(width=64, height=64, quality=30, batch=2048,
                         iters_per_chunk=8, hist_backend=backend,
                         de_enabled=True, fuse=8)
    sr = ShardedRenderer(g, prof)
    img_r, st_r = sr.render_frame(0.0, seed=3)
    img_s, st_s = sr.render_frame_scattered(0.0, seed=3)
    assert st_s.plotted_samples == st_r.plotted_samples
    d = np.abs(np.asarray(img_r).astype(int) - img_s.astype(int))
    assert d.max() <= 1, d.max()


def test_scattered_blocks_density_exact(eight_devices):
    """Each scattered block must equal the corresponding rows of the
    replicated psum histogram EXACTLY in density (integer counts; the
    scatter is the same sum, distributed)."""
    from cuburn_tpu.parallel import ShardedRenderer
    g = sierpinski()
    prof = RenderProfile(width=64, height=64, quality=25, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=True, fuse=8)
    sr = ShardedRenderer(g, prof)
    hist, _ = sr.accumulate(0.0, seed=7)          # replicated psum
    blocks, _ = sr.accumulate_scattered(0.0, seed=7)
    cam = sr.cam
    de_on = sr._de_on(
        __import__("cuburn_tpu.render", fromlist=["_to_device"])
        ._to_device(g.eval_at(0.0)))
    h_band, band_rows, margin, block_rows, pad_bot = \
        sr._band_geometry(de_on)
    img = np.asarray(hist)[:-1].reshape(cam.acc_height,
                                        cam.acc_width, 4)
    img = np.pad(img, ((margin, pad_bot), (0, 0), (0, 0)))
    blocks = np.asarray(blocks)
    for k in range(sr.n_devices):
        ref = img[cam.gutter + k * band_rows:
                  cam.gutter + k * band_rows + block_rows]
        np.testing.assert_array_equal(blocks[k][..., 3], ref[..., 3])
        np.testing.assert_allclose(blocks[k], ref, atol=1e-3)


def test_scattered_mode_odd_height_and_cap(eight_devices):
    """Scattered mode at a height not divisible by the mesh size and
    under dispatch_iter_cap: capped calls accumulate into the carried
    blocks through ONE traced program and still match the replicated
    render."""
    import dataclasses
    from cuburn_tpu.parallel import ShardedRenderer
    g = sierpinski()
    prof = RenderProfile(width=72, height=50, quality=30, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=True, fuse=8)
    sr = ShardedRenderer(g, prof)
    img_r, _ = sr.render_frame(0.0, seed=5)
    prof_c = dataclasses.replace(prof, dispatch_iter_cap=2048 * 8)
    src = ShardedRenderer(g, prof_c)
    img_s, st_s = src.render_frame_scattered(0.0, seed=5)
    assert img_s.shape == (50, 72, 4)
    d = np.abs(np.asarray(img_r).astype(int) - img_s.astype(int))
    assert d.max() <= 1, d.max()
    assert st_s.plotted_samples > 0


def test_scattered_temporal_matches_replicated(eight_devices):
    """Motion blur through the scattered mode (single-dispatch
    temporal collective + sample-group and per-chunk cap ladders) must
    match the replicated temporal render within one u8 step."""
    import dataclasses
    from cuburn_tpu.models import animated_spark
    from cuburn_tpu.parallel import ShardedRenderer
    g = animated_spark()
    prof = RenderProfile(width=64, height=64, quality=24, batch=2048,
                         iters_per_chunk=8, hist_backend="scatter",
                         de_enabled=True, fuse=8, temporal_samples=3)
    sr = ShardedRenderer(g, prof)
    img_r, st_r = sr.render_frame(0.5, seed=4)
    img_s, st_s = sr.render_frame_scattered(0.5, seed=4)
    assert st_s.plotted_samples == st_r.plotted_samples
    d = np.abs(np.asarray(img_r).astype(int) - img_s.astype(int))
    assert d.max() <= 1, d.max()
    # capped variants (sample groups, then per-chunk splitting) must
    # reproduce the uncapped scattered frame
    for cap in (2048 * 8 * 3, 2048 * 8):
        prof_c = dataclasses.replace(prof, dispatch_iter_cap=cap)
        img_c, st_c = ShardedRenderer(
            g, prof_c).render_frame_scattered(0.5, seed=4)
        assert st_c.plotted_samples == st_s.plotted_samples, cap
        dc = np.abs(img_c.astype(int) - img_s.astype(int))
        assert dc.max() <= 1, (cap, dc.max())


def test_scattered_overlapped_frames_identical(eight_devices):
    """The scattered overlapped animation driver must yield frames
    bit-identical to serial render_frame_scattered calls at the same
    per-frame seeds (only host synchronization moves)."""
    from cuburn_tpu.models import animated_spark
    from cuburn_tpu.parallel import ShardedRenderer
    g = animated_spark()
    prof = RenderProfile(width=64, height=64, quality=15, batch=2048,
                         iters_per_chunk=8, fuse=8, fps=4.0,
                         duration=0.75, hist_backend="scatter",
                         de_enabled=True)
    r = ShardedRenderer(g, prof)
    serial = [r.render_frame_scattered(t, seed=2 + k)[0]
              for k, t in r.frame_times()]
    overlapped = list(r.frames_overlapped_scattered(seed=2))
    assert len(serial) == len(overlapped) == 3
    for a, (b, sb) in zip(serial, overlapped):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert sb.plotted_samples > 0


def test_sharded_sortcum_matches_scatter(eight_devices):
    """The segmented-sum backend through shard_map: same RNG
    stream as sharded scatter, so density must match per-bin exactly."""
    import dataclasses
    from cuburn_tpu.parallel import ShardedRenderer
    g = sierpinski()
    prof = RenderProfile(width=64, height=64, quality=30, batch=2048,
                         iters_per_chunk=8, hist_backend="sortcum",
                         de_enabled=False, fuse=8)
    h_o, st_o = ShardedRenderer(g, prof).accumulate(0.0, seed=3)
    prof_s = dataclasses.replace(prof, hist_backend="scatter")
    h_s, st_s = ShardedRenderer(g, prof_s).accumulate(0.0, seed=3)
    assert st_o.plotted_samples == st_s.plotted_samples
    a, b = np.asarray(h_s), np.asarray(h_o)
    np.testing.assert_array_equal(a[:, 3], b[:, 3])
    assert np.abs(a - b).max() < 1e-2
